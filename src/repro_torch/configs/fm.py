"""fm [Rendle, ICDM'10].

Pure second-order factorization machine, embed_dim=10, O(nk) sum-square
trick. Retrieval decomposes to exact MIPS (models/recsys.fm_item_vectors).
"""
from repro_torch.configs.base import RecsysConfig

FULL = RecsysConfig(
    name="fm", kind="fm",
    n_sparse=39, n_dense=13, embed_dim=10,
    total_vocab=33_000_000,
)

SMOKE = RecsysConfig(
    name="fm-smoke", kind="fm",
    n_sparse=6, n_dense=3, embed_dim=8,
    total_vocab=2_000,
)
