"""stablelm-3b [hf:stabilityai/stablelm-2-1_6b family, 3B point].

32L d_model=2560 32H (GQA kv=32) d_ff=6912 vocab=50304.
"""
from repro_torch.configs.base import LMConfig

FULL = LMConfig(
    name="stablelm-3b",
    n_layers=32, d_model=2560, n_heads=32, n_kv_heads=32, d_ff=6912,
    vocab_size=50_304,
    norm="layernorm", gated_mlp=True, act="silu", qkv_bias=False,
    rope_theta=10_000.0, rope_pct=0.25,
    pool="mean",
)

SMOKE = LMConfig(
    name="stablelm-3b-smoke",
    n_layers=2, d_model=80, n_heads=4, n_kv_heads=4, d_ff=216,
    vocab_size=512,
    norm="layernorm", gated_mlp=True, act="silu",
    rope_theta=10_000.0, rope_pct=0.25,
    pool="mean", attn_chunk=32, attn_chunk_threshold=64,
)
