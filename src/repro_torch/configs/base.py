"""Config dataclasses of every model family (port of
``repro.configs.base``: ``MLAConfig``, ``MoEConfig``, ``LMConfig``,
``EncoderConfig``, ``GNNConfig`` and ``RecsysConfig``, copied field for
field so that a config compares equal to the reference's);
``configs.registry`` lists every arch id.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek multi-head latent attention dims [arXiv:2405.04434]."""

    kv_lora_rank: int = 512
    q_lora_rank: Optional[int] = None  # None => full-rank q projection
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128

    @property
    def cache_dim(self) -> int:
        # decode cache stores the compressed latent + shared rope key
        return self.kv_lora_rank + self.qk_rope_dim


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """Top-k routed MoE with optional shared experts [arXiv:2401.06066]."""

    n_routed: int
    top_k: int
    n_shared: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 1e-3
    router_z_weight: float = 1e-4
    # tokens per dispatch group; groups shard over the data axis (MaxText-style).
    # Dispatch-mask memory is T*E*C = T*t*k*cf, linear in the group size t, so
    # small groups keep the one-hot tensors tiny while C = t*k*cf/E stays >= 4.
    group_size: int = 128
    # "einsum": GShard one-hot dispatch (paper-faithful baseline) — costs
    # 2*T*E*C*D matmul flops, ~50x the expert math at E=256 (deepseek-v3).
    # "gather": scatter/gather dispatch — same capacity semantics, bandwidth
    # instead of MXU flops (§Perf deepseek-v3 train iteration 2).
    dispatch: str = "einsum"


@dataclasses.dataclass(frozen=True)
class LMConfig:
    """Decoder LM / bidirectional encoder transformer config."""

    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0  # 0 => d_model // n_heads
    # block structure
    norm: str = "rmsnorm"  # "rmsnorm" | "layernorm"
    gated_mlp: bool = True
    act: str = "silu"
    qkv_bias: bool = False
    parallel_residual: bool = False
    # position
    rope_theta: float = 10_000.0
    rope_pct: float = 1.0  # partial rotary (stablelm uses 0.25)
    # attention
    causal: bool = True
    window: Optional[int] = None  # sliding-window attention (h2o-danube)
    attn_chunk: int = 1024  # flash chunk (both q and kv)
    attn_chunk_threshold: int = 2048  # use chunked attention for seq >= this
    # MLA / MoE
    mla: Optional[MLAConfig] = None
    moe: Optional[MoEConfig] = None
    first_k_dense: int = 0  # leading dense layers in a MoE model
    dense_d_ff: int = 0  # d_ff of those dense layers (0 => d_ff)
    # MTP (deepseek-v3 multi-token prediction)
    mtp_depth: int = 0
    mtp_loss_weight: float = 0.3
    # embedding / head
    tie_embeddings: bool = False
    pool: str = "none"  # "none" | "cls" | "mean" | "max" (encoder pooling)
    max_seq_len: int = 131_072
    # numerics
    param_dtype: str = "float32"
    dtype: str = "bfloat16"  # activation/compute dtype

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    @property
    def n_moe_layers(self) -> int:
        return 0 if self.moe is None else self.n_layers - self.first_k_dense

    @property
    def n_dense_layers(self) -> int:
        return self.n_layers if self.moe is None else self.first_k_dense

    @property
    def dense_ff(self) -> int:
        return self.dense_d_ff or self.d_ff

    def n_params(self) -> int:
        """Total parameter count (embedding + blocks + head), exact."""
        d, v = self.d_model, self.vocab_size
        total = v * d  # embed
        if not self.tie_embeddings:
            total += d * v  # head
        total += d  # final norm

        def attn_params() -> int:
            h, dh = self.n_heads, self.head_dim
            if self.mla is not None:
                m = self.mla
                qk = m.qk_nope_dim + m.qk_rope_dim
                p = 0
                if m.q_lora_rank:
                    p += d * m.q_lora_rank + m.q_lora_rank + m.q_lora_rank * h * qk
                else:
                    p += d * h * qk
                p += d * (m.kv_lora_rank + m.qk_rope_dim) + m.kv_lora_rank
                p += m.kv_lora_rank * h * (m.qk_nope_dim + m.v_head_dim)
                p += h * m.v_head_dim * d
                return p
            kv = self.n_kv_heads
            p = d * h * dh + 2 * d * kv * dh + h * dh * d
            if self.qkv_bias:
                p += (h + 2 * kv) * dh
            return p

        def mlp_params(ff: int) -> int:
            n_in = 2 if self.gated_mlp else 1
            return n_in * d * ff + ff * d

        per_layer_norms = 2 * d
        for _ in range(self.n_dense_layers):
            total += attn_params() + mlp_params(self.dense_ff) + per_layer_norms
        if self.moe is not None:
            m = self.moe
            expert = mlp_params(m.d_ff_expert)
            for _ in range(self.n_moe_layers):
                total += attn_params() + per_layer_norms
                total += d * m.n_routed  # router
                total += m.n_routed * expert + m.n_shared * expert
        if self.mtp_depth:
            total += self.mtp_depth * (
                attn_params() + mlp_params(self.dense_ff) + per_layer_norms + 2 * d * d
            )
        return total

    def n_active_params(self) -> int:
        """Active params per token (MoE: only routed top-k + shared)."""
        if self.moe is None:
            return self.n_params()
        d = self.d_model
        m = self.moe
        n_in = 2 if self.gated_mlp else 1
        expert = n_in * d * m.d_ff_expert + m.d_ff_expert * d
        inactive = (m.n_routed - m.top_k) * expert * self.n_moe_layers
        return self.n_params() - inactive


@dataclasses.dataclass(frozen=True)
class EncoderConfig(LMConfig):
    """SBERT-style bidirectional encoder (the paper's embedding model)."""

    causal: bool = False
    pool: str = "mean"
    project_dim: int = 0  # optional projection after pooling (0 = off)
    normalize: bool = True


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    name: str = "graphsage"
    n_layers: int = 2
    d_hidden: int = 128
    d_in: int = 602
    n_classes: int = 41
    aggregator: str = "mean"  # "mean" | "max" | "sum"
    sample_sizes: Tuple[int, ...] = (25, 10)
    dtype: str = "float32"
    param_dtype: str = "float32"
    # wire precision of neighbor messages: the gather over shard boundaries is
    # the dominant collective on full-graph cells; bf16 halves it while the
    # segment reduction still accumulates in f32 (§Perf ogb_products)
    message_dtype: str = "float32"

    def n_params(self) -> int:
        total = 0
        d_prev = self.d_in
        for _ in range(self.n_layers):
            total += 2 * d_prev * self.d_hidden + self.d_hidden  # self + neigh + bias
            d_prev = self.d_hidden
        total += d_prev * self.n_classes + self.n_classes
        return total


@dataclasses.dataclass(frozen=True)
class RecsysConfig:
    name: str = "fm"
    kind: str = "fm"  # "fm" | "deepfm" | "autoint" | "sasrec"
    n_sparse: int = 39
    n_dense: int = 13
    embed_dim: int = 10
    # per-field vocab sizes; () => synthesized power-law table sizes
    vocab_sizes: Tuple[int, ...] = ()
    total_vocab: int = 33_000_000
    mlp_dims: Tuple[int, ...] = ()
    # autoint
    n_attn_layers: int = 0
    n_attn_heads: int = 0
    d_attn: int = 0
    # sasrec
    n_items: int = 0
    seq_len: int = 0
    n_blocks: int = 0
    dtype: str = "float32"
    param_dtype: str = "float32"

    def field_vocab_sizes(self) -> Tuple[int, ...]:
        if self.vocab_sizes:
            return self.vocab_sizes
        # deterministic power-law split of total_vocab across fields (criteo-like:
        # a few huge ID tables, a long tail of small ones). The unified table's
        # total is rounded up to a 2048 multiple so its rows shard evenly over
        # any production mesh (256/512 devices); pad rows are never indexed.
        n = self.n_sparse
        if n == 0:  # sequence models (sasrec) have no sparse fields
            return ()
        weights = [1.0 / (i + 1) ** 1.1 for i in range(n)]
        s = sum(weights)
        sizes = [max(4, int(self.total_vocab * w / s)) for w in weights]
        pad = (-sum(sizes)) % 2048
        sizes[0] += pad
        return tuple(sizes)

    def n_params(self) -> int:
        if self.kind == "sasrec":
            d = self.embed_dim
            per_block = 4 * d * d + 2 * d * d + 4 * d + 2 * d  # attn + pffn + norms
            return (self.n_items + 1) * d + self.seq_len * d + self.n_blocks * per_block
        total = sum(self.field_vocab_sizes()) * self.embed_dim  # V embedding
        total += sum(self.field_vocab_sizes())  # first-order weights
        total += self.n_dense * self.embed_dim + self.n_dense  # dense projections
        d_in = (self.n_sparse + self.n_dense) * self.embed_dim
        for h in self.mlp_dims:
            total += d_in * h + h
            d_in = h
        if self.mlp_dims:
            total += d_in + 1
        if self.n_attn_layers:
            d = self.embed_dim
            da = self.d_attn * self.n_attn_heads
            total += self.n_attn_layers * (3 * d * da + da * d)
        return total
