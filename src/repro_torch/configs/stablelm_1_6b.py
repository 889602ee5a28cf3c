"""stablelm-1.6b [hf:stabilityai/stablelm-2-1_6b].

24L d_model=2048 32H (GQA kv=32 = full MHA) d_ff=5632 vocab=100352.
StableLM-2 block: LayerNorm, partial rotary (25%), SwiGLU MLP, qkv bias.
"""
from repro_torch.configs.base import LMConfig

FULL = LMConfig(
    name="stablelm-1.6b",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32, d_ff=5632,
    vocab_size=100_352,
    norm="layernorm", gated_mlp=True, act="silu", qkv_bias=True,
    rope_theta=10_000.0, rope_pct=0.25,
    pool="mean",
)

SMOKE = LMConfig(
    name="stablelm-1.6b-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=176,
    vocab_size=512,
    norm="layernorm", gated_mlp=True, act="silu", qkv_bias=True,
    rope_theta=10_000.0, rope_pct=0.25,
    pool="mean", attn_chunk=32, attn_chunk_threshold=64,
)
