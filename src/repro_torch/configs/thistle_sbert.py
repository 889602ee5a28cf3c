"""thistle-sbert — the paper's own embedding model (SBERT-base shape; port
of ``repro.configs.thistle_sbert``, the same two configs).

12L bidirectional encoder, d_model=768 (the paper's embedding size), 12H,
d_ff=3072, mean pooling (paper default; cls/max selectable), ~110M params.
This is the "~100M model" the end-to-end training example fits with the
siamese contrastive objective.
"""
from repro_torch.configs.base import EncoderConfig

FULL = EncoderConfig(
    name="thistle-sbert",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12, d_ff=3072,
    vocab_size=30_522,
    norm="layernorm", gated_mlp=False, act="gelu",
    causal=False, pool="mean", normalize=True,
    max_seq_len=512,
)

SMOKE = EncoderConfig(
    name="thistle-sbert-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab_size=1_000,
    norm="layernorm", gated_mlp=False, act="gelu",
    causal=False, pool="mean", normalize=True,
    max_seq_len=64, attn_chunk=32, attn_chunk_threshold=64,
)
