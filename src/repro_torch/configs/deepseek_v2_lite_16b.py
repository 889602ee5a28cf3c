"""deepseek-v2-lite-16b [arXiv:2405.04434].

27L d_model=2048 16H MLA (kv_lora=512, no q-lora in Lite) vocab=102400,
MoE: 64 routed top-6 + 2 shared, expert d_ff=1408, first layer dense
(d_ff=10944). Softmax router.
"""
from repro_torch.configs.base import LMConfig, MLAConfig, MoEConfig

FULL = LMConfig(
    name="deepseek-v2-lite-16b",
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=1408,
    vocab_size=102_400,
    norm="rmsnorm", gated_mlp=True, act="silu",
    rope_theta=10_000.0,
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=None, qk_nope_dim=128,
                  qk_rope_dim=64, v_head_dim=128),
    moe=MoEConfig(n_routed=64, top_k=6, n_shared=2, d_ff_expert=1408,
                  capacity_factor=1.25, group_size=256),
    first_k_dense=1, dense_d_ff=10_944,
    pool="mean",
)

SMOKE = LMConfig(
    name="deepseek-v2-lite-16b-smoke",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=48,
    vocab_size=512,
    norm="rmsnorm", gated_mlp=True, act="silu",
    mla=MLAConfig(kv_lora_rank=32, q_lora_rank=None, qk_nope_dim=16,
                  qk_rope_dim=8, v_head_dim=16),
    moe=MoEConfig(n_routed=8, top_k=2, n_shared=2, d_ff_expert=48,
                  group_size=32, capacity_factor=8.0),
    first_k_dense=1, dense_d_ff=128,
    pool="mean", attn_chunk=32, attn_chunk_threshold=64,
)
