"""autoint [arXiv:1810.11921].

39 sparse fields, embed_dim=16, 3 self-attn interaction layers (2 heads x
d_attn 32). Criteo-scale unified table (power-law field vocabs).
"""
from repro_torch.configs.base import RecsysConfig

FULL = RecsysConfig(
    name="autoint", kind="autoint",
    n_sparse=39, n_dense=13, embed_dim=16,
    n_attn_layers=3, n_attn_heads=2, d_attn=32,
    total_vocab=33_000_000,
)

SMOKE = RecsysConfig(
    name="autoint-smoke", kind="autoint",
    n_sparse=6, n_dense=3, embed_dim=8,
    n_attn_layers=2, n_attn_heads=2, d_attn=4,
    total_vocab=2_000,
)
