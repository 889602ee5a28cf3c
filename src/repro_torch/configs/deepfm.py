"""deepfm [arXiv:1703.04247].

39 sparse fields, embed_dim=10, deep tower 400-400-400, FM second order.
"""
from repro_torch.configs.base import RecsysConfig

FULL = RecsysConfig(
    name="deepfm", kind="deepfm",
    n_sparse=39, n_dense=13, embed_dim=10,
    mlp_dims=(400, 400, 400),
    total_vocab=33_000_000,
)

SMOKE = RecsysConfig(
    name="deepfm-smoke", kind="deepfm",
    n_sparse=6, n_dense=3, embed_dim=8,
    mlp_dims=(32, 32),
    total_vocab=2_000,
)
