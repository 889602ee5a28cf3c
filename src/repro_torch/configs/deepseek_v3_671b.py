"""deepseek-v3-671b [arXiv:2412.19437].

61L d_model=7168 128H MLA (q_lora=1536, kv_lora=512) vocab=129280,
MoE: 256 routed top-8 + 1 shared, expert d_ff=2048, first 3 layers dense
(d_ff=18432), sigmoid router, MTP depth 1.

param_dtype is bf16: fp32 params + fp32 Adam for 671B = 8.1 TB, more than a
512-chip v5e's HBM before activations — DeepSeek themselves train in
fp8/bf16 mixed precision; we pair bf16 params with the int8-blockwise Adam
state (repro.train.optim) and quantify the fit in EXPERIMENTS.md §Perf.
"""
from repro_torch.configs.base import LMConfig, MLAConfig, MoEConfig

FULL = LMConfig(
    name="deepseek-v3-671b",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128, d_ff=2048,
    vocab_size=129_280,
    norm="rmsnorm", gated_mlp=True, act="silu",
    rope_theta=10_000.0,
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536, qk_nope_dim=128,
                  qk_rope_dim=64, v_head_dim=128),
    moe=MoEConfig(n_routed=256, top_k=8, n_shared=1, d_ff_expert=2048,
                  capacity_factor=1.25, group_size=256),
    first_k_dense=3, dense_d_ff=18_432,
    mtp_depth=1,
    pool="mean",
    param_dtype="bfloat16",
)

SMOKE = LMConfig(
    name="deepseek-v3-671b-smoke",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, d_ff=48,
    vocab_size=512,
    norm="rmsnorm", gated_mlp=True, act="silu",
    mla=MLAConfig(kv_lora_rank=32, q_lora_rank=24, qk_nope_dim=16,
                  qk_rope_dim=8, v_head_dim=16),
    moe=MoEConfig(n_routed=16, top_k=4, n_shared=1, d_ff_expert=48,
                  group_size=32, capacity_factor=8.0),
    first_k_dense=1, dense_d_ff=128,
    mtp_depth=1,
    pool="mean", attn_chunk=32, attn_chunk_threshold=64,
)
