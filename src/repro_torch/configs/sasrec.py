"""sasrec [arXiv:1808.09781].

embed_dim=50 n_blocks=2 n_heads=1 seq_len=50, self-attentive sequential rec.
n_items set to 1M so retrieval_cand scores the full item corpus.
"""
from repro_torch.configs.base import RecsysConfig

FULL = RecsysConfig(
    name="sasrec", kind="sasrec",
    embed_dim=50, n_blocks=2, n_attn_heads=1, seq_len=50,
    n_items=1_000_000,
    n_sparse=0, n_dense=0,
)

SMOKE = RecsysConfig(
    name="sasrec-smoke", kind="sasrec",
    embed_dim=16, n_blocks=2, n_attn_heads=1, seq_len=12,
    n_items=500,
    n_sparse=0, n_dense=0,
)
