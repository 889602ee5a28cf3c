"""h2o-danube-1.8b [arXiv:2401.16818] — llama+mistral mix with sliding-window.

24L d_model=2560 32H (GQA kv=8) d_ff=6912 vocab=32000, SWA window 4096.
The SWA ring-buffer cache is what makes this the one LM arch that runs
long_500k (O(window) decode memory/compute).
"""
from repro_torch.configs.base import LMConfig

FULL = LMConfig(
    name="h2o-danube-1.8b",
    n_layers=24, d_model=2560, n_heads=32, n_kv_heads=8, d_ff=6912,
    vocab_size=32_000,
    norm="rmsnorm", gated_mlp=True, act="silu",
    rope_theta=10_000.0, rope_pct=1.0,
    window=4096,
    pool="mean",
)

SMOKE = LMConfig(
    name="h2o-danube-1.8b-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=192,
    vocab_size=512,
    norm="rmsnorm", gated_mlp=True, act="silu",
    window=32,
    pool="mean", attn_chunk=32, attn_chunk_threshold=64,
)
