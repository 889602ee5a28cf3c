"""Attention: GQA (with its sliding window) and MLA, DeepSeek's latent
attention (port of ``repro.models.attention``).

Serving: on a CUDA tensor the attention core is the hand-written kernel
(``kernels.ops.flash_attention``, ``csrc/flash_attention.cu``) at every
length, the counterpart of the reference's Pallas TPU path. On a CPU tensor
(or with ``use_kernel=False``) it is the reference's rule between its two
plain versions (``dense_or_chunked_attention``): the materialized
``_dense_attention`` below the config's ``attn_chunk_threshold``, the
online-softmax ``_chunked_attention`` (the kernel's twin, which never holds
the (Sq, Sk) scores) at and above it.

Training (``gqa_attention(..., train=True)``) always takes that rule, on
every device, under autograd: the reference's training differentiates its
jnp rule and never reaches the Pallas kernel, which has no VJP, and the
port's kernel is forward only too. The chunked path recomputes each kv
step in the backward pass, as ``jax.checkpoint(kv_step)`` does.

Decode (one query token against a KV cache) is plain PyTorch, as the
reference's is plain ``jnp``: ``gqa_decode`` reads a ring buffer for a
sliding window (slot ``pos % C``), ``mla_decode`` scores and mixes in the
512-wide latent space with the decompression absorbed into the query, so
the cache stays compressed. Both write the new position into the cache
in place and return it. MLA's prefill pads v to the q/k width (192 at
DeepSeek's dims) so that it runs through the same attention core, the
kernel included.
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import LMConfig
from repro_torch.device import bf16_exact_tf32, kernel_path, strict_fp32
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import NEG_INF, flash_attention_plain
from repro_torch.models.layers import Norm, apply_norm, apply_rope, dense_init

# =================================================================== init


class Attention(nn.Module):
    """GQA projections: ``wq`` (d, h, dh), ``wk`` and ``wv`` (d, kv, dh),
    ``wo`` (h, dh, d), and with ``qkv_bias`` ``bq``, ``bk``, ``bv``."""

    def __init__(self, generator, cfg: LMConfig, dtype=torch.float32):
        super().__init__()
        d, h, dh, kv = cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.n_kv_heads
        self.wq = dense_init(generator, d, (h, dh), dtype)
        self.wk = dense_init(generator, d, (kv, dh), dtype)
        self.wv = dense_init(generator, d, (kv, dh), dtype)
        self.wo = nn.Parameter(dense_init(generator, h * dh, d, dtype)
                               .detach().reshape(h, dh, d))
        if cfg.qkv_bias:
            dev = generator.device
            self.bq = nn.Parameter(torch.zeros((h, dh), dtype=dtype, device=dev))
            self.bk = nn.Parameter(torch.zeros((kv, dh), dtype=dtype, device=dev))
            self.bv = nn.Parameter(torch.zeros((kv, dh), dtype=dtype, device=dev))
        else:
            for name in ("bq", "bk", "bv"):
                self.register_parameter(name, None)


class MLAttention(nn.Module):
    """MLA projections under the reference's names: with a q low rank
    ``wq_a`` (d, q_lora), ``q_norm`` and ``wq_b`` (q_lora, h, qk), else
    ``wq`` (d, h, qk); ``wkv_a`` (d, kv_lora + qk_rope), ``kv_norm``,
    ``wkv_b`` (kv_lora, h, qk_nope + v) and ``wo`` (h, v, d), with
    qk = qk_nope + qk_rope."""

    def __init__(self, generator, cfg: LMConfig, dtype=torch.float32):
        super().__init__()
        m, d, h = cfg.mla, cfg.d_model, cfg.n_heads
        dev = generator.device
        qk = m.qk_nope_dim + m.qk_rope_dim
        if m.q_lora_rank:
            self.wq_a = dense_init(generator, d, m.q_lora_rank, dtype)
            self.q_norm = Norm("rmsnorm", m.q_lora_rank, dtype, dev)
            self.wq_b = dense_init(generator, m.q_lora_rank, (h, qk), dtype)
            self.register_parameter("wq", None)
        else:
            self.wq = dense_init(generator, d, (h, qk), dtype)
            self.register_parameter("wq_a", None)
            self.q_norm = None
            self.register_parameter("wq_b", None)
        self.wkv_a = dense_init(generator, d, m.kv_lora_rank + m.qk_rope_dim,
                                dtype)
        self.kv_norm = Norm("rmsnorm", m.kv_lora_rank, dtype, dev)
        self.wkv_b = dense_init(generator, m.kv_lora_rank,
                                (h, m.qk_nope_dim + m.v_head_dim), dtype)
        self.wo = nn.Parameter(dense_init(generator, h * m.v_head_dim, d, dtype)
                               .detach().reshape(h, m.v_head_dim, d))


def init_attention(generator, cfg: LMConfig, dtype=torch.float32):
    if cfg.mla is not None:
        return MLAttention(generator, cfg, dtype)
    return Attention(generator, cfg, dtype)


# ============================================================ core attention


def _dense_attention(q, k, v, *, scale, causal, window, q_offset, kv_mask=None):
    """Materialized-scores attention. q:(B,Sq,KV,rep,dh) k/v:(B,Sk,KV,dh)."""
    B, Sq, KV, rep, dh = q.shape
    o = flash_attention_plain(q.reshape(B, Sq, KV * rep, dh), k, v,
                              causal=causal, scale=scale, kv_mask=kv_mask,
                              window=window, q_offset=q_offset)
    return o.reshape(B, Sq, KV, rep, dh)


def _kv_step(m, l, acc, q_blk, k_blk, v_blk, keep, kvm, scale, bf16=False):
    """One kv chunk of the online softmax: (m, l, acc) -> (m, l, acc).
    ``keep`` (qc, kc) is the causal/window mask, ``kvm`` (B, kc) the
    padding mask or None. ``bf16``: q, k and v hold bf16 values, so the
    two products run as TF32 on the card (``bf16_exact_tf32``: the
    products exact, the sums float32 in the tensor cores' order); float32
    operands keep the caller's full float32."""
    with bf16_exact_tf32() if bf16 else contextlib.nullcontext():
        s = torch.einsum("bqnrd,bknd->bnrqk", q_blk, k_blk.float()) * scale
    s = torch.where(keep, s, NEG_INF)
    if kvm is not None:
        s = torch.where(kvm[:, None, None, None, :], s, NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(dim=-1)
    with bf16_exact_tf32() if bf16 else contextlib.nullcontext():
        pv = torch.einsum("bnrqk,bknd->bnrqd", p.to(v_blk.dtype).float(),
                          v_blk.float()).to(v_blk.dtype)
    return m_new, l_new, acc * corr[..., None] + pv.float()


@strict_fp32()
def _chunked_attention(q, k, v, *, scale, causal, window, q_offset, q_chunk,
                       k_chunk, kv_mask=None):
    """Flash-style double loop; never materializes (Sq, Sk).

    q: (B, Sq, KV, rep, dh); k, v: (B, Sk, KV, dh). Returns (B, Sq, KV, rep, dh).
    Running max, denominator and accumulator are float32; p is rounded to
    v's dtype before the p v product, as in the reference. Under autograd
    each kv step is checkpointed (``use_reentrant=False``), as the
    reference's ``jax.checkpoint(kv_step)``: the backward pass recomputes
    the (qc, kc) score block instead of keeping all of them.

    Without a padding mask or an offset (Sq <= Sk), a (q chunk, kv
    chunk) pair that the causal mask or the window masks whole is skipped:
    its scores are NEG_INF, so it adds exact zeros after a live chunk and
    is wiped by the first live chunk's rescale (exp(NEG_INF - m) = 0)
    before one (every row's own key is live, in a chunk that is never
    skipped). Skipping changes no bit; TF32 for bf16 inputs (``_kv_step``)
    changes the float32 sums' rounding only.
    """
    B, Sq, KV, rep, dh = q.shape
    Sk = k.shape[1]
    q_chunk = min(q_chunk, Sq)
    k_chunk = min(k_chunk, Sk)
    assert Sq % q_chunk == 0 and Sk % k_chunk == 0, (Sq, q_chunk, Sk, k_chunk)
    dev = q.device
    remat = torch.is_grad_enabled()
    bf16 = q.dtype == k.dtype == v.dtype == torch.bfloat16
    may_skip = kv_mask is None and q_offset == 0 and Sq <= Sk
    outs = []
    for q0 in range(0, Sq, q_chunk):
        q_blk = q[:, q0:q0 + q_chunk].float()
        q_pos = q_offset + q0 + torch.arange(q_chunk, device=dev)
        m = torch.full((B, KV, rep, q_chunk), NEG_INF, device=dev)
        l = torch.zeros((B, KV, rep, q_chunk), device=dev)
        acc = torch.zeros((B, KV, rep, q_chunk, dh), device=dev)
        q_first = q_offset + q0
        for k0 in range(0, Sk, k_chunk):
            if may_skip and (
                    (causal and k0 > q_first + q_chunk - 1)
                    or (window is not None
                        and q_first - (k0 + k_chunk - 1) >= window)):
                continue
            k_pos = k0 + torch.arange(k_chunk, device=dev)
            keep = (q_pos[:, None] >= k_pos[None, :] if causal else
                    torch.ones((q_chunk, k_chunk), dtype=torch.bool, device=dev))
            if window is not None:
                keep &= q_pos[:, None] - k_pos[None, :] < window
            kvm = None if kv_mask is None else kv_mask[:, k0:k0 + k_chunk]
            args = (m, l, acc, q_blk, k[:, k0:k0 + k_chunk],
                    v[:, k0:k0 + k_chunk], keep, kvm, scale, bf16)
            m, l, acc = (checkpoint(_kv_step, *args, use_reentrant=False)
                         if remat else _kv_step(*args))
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        # (B, KV, rep, qc, dh) -> (B, qc, KV, rep, dh)
        outs.append(torch.movedim(out, 3, 1).to(q.dtype))
    return torch.cat(outs, dim=1)


def dense_or_chunked_attention(q, k, v, cfg: LMConfig, *, causal, window,
                               q_offset=0, kv_mask=None,
                               scale: Optional[float] = None):
    """The reference's ``multihead_attention`` rule, differentiable on any
    device: ``_chunked_attention`` where max(Sq, Sk) reaches the config's
    ``attn_chunk_threshold`` (and Sq splits into chunks), else
    ``_dense_attention``. q:(B,Sq,H,dh) k/v:(B,Sk,KV,dh) -> (B,Sq,H,dh).

    Training runs attention through this by name: the reference's
    ``jax.value_and_grad`` differentiates this jnp rule (no model calls
    its Pallas kernel, which has no VJP), and the port's CUDA kernel is
    forward only, so the training forward never reaches it."""
    B, Sq, H, dh = q.shape
    KV = k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    qr = q.reshape(B, Sq, KV, H // KV, dh)
    if (max(Sq, k.shape[1]) >= cfg.attn_chunk_threshold
            and Sq % min(cfg.attn_chunk, Sq) == 0):
        o = _chunked_attention(qr, k, v, scale=scale, causal=causal,
                               window=window, q_offset=q_offset,
                               q_chunk=cfg.attn_chunk, k_chunk=cfg.attn_chunk,
                               kv_mask=kv_mask)
    else:
        o = _dense_attention(qr, k, v, scale=scale, causal=causal,
                             window=window, q_offset=q_offset, kv_mask=kv_mask)
    return o.reshape(B, Sq, H, dh)


def multihead_attention(q, k, v, cfg: LMConfig, *, causal, window, q_offset=0,
                        kv_mask=None, scale: Optional[float] = None,
                        use_kernel=None):
    """q:(B,Sq,H,dh) k/v:(B,Sk,KV,dh) -> (B,Sq,H,dh). A CUDA tensor takes
    the kernel, with the sliding window (which raises on an offset or
    inputs that need a gradient); a CPU tensor, or ``use_kernel=False``,
    the reference's dense/chunked rule (``dense_or_chunked_attention``)."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if kernel_path(q, use_kernel):
        if q_offset:
            raise ValueError("flash_attention kernel serves full sequences "
                             f"(q_offset 0), got q_offset={q_offset}")
        return ops.flash_attention(q, k, v, causal=causal, scale=scale,
                                   kv_mask=kv_mask, window=window,
                                   use_kernel=True)
    return dense_or_chunked_attention(q, k, v, cfg, causal=causal,
                                      window=window, q_offset=q_offset,
                                      kv_mask=kv_mask, scale=scale)


# ============================================================ GQA block


def _core(q, k, v, cfg: LMConfig, *, kv_mask, use_kernel, train,
          scale=None):
    """The full-sequence attention core under the config's causal flag and
    window: ``dense_or_chunked_attention`` when training, else
    ``multihead_attention``'s dispatch."""
    if train:
        return dense_or_chunked_attention(q, k, v, cfg, causal=cfg.causal,
                                          window=cfg.window, kv_mask=kv_mask,
                                          scale=scale)
    return multihead_attention(q, k, v, cfg, causal=cfg.causal,
                               window=cfg.window, kv_mask=kv_mask, scale=scale,
                               use_kernel=use_kernel)


def _gqa_qkv(p: Attention, cfg: LMConfig, x, positions):
    """q (B, S, H, dh), k and v (B, S, KV, dh), with the biases and, on q
    and k, rotary at ``positions`` ((S,) or (B, S))."""
    B, S, D = x.shape
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ p.wq.to(x.dtype).reshape(D, H * dh)).view(B, S, H, dh)
    k = (x @ p.wk.to(x.dtype).reshape(D, KV * dh)).view(B, S, KV, dh)
    v = (x @ p.wv.to(x.dtype).reshape(D, KV * dh)).view(B, S, KV, dh)
    if p.bq is not None:
        q = q + p.bq.to(x.dtype)
        k = k + p.bk.to(x.dtype)
        v = v + p.bv.to(x.dtype)
    if positions.dim() == 1:
        positions = positions[None, :]
    q = apply_rope(q, positions, cfg.rope_theta, cfg.rope_pct)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.rope_pct)
    return q, k, v


def gqa_attention(p: Attention, cfg: LMConfig, x, positions, *, kv_mask=None,
                  use_kernel=None, train: bool = False,
                  return_kv: bool = False):
    """Full-sequence GQA attention (train / prefill). x: (B, S, D);
    positions: (S,) or (B, S). Returns (B, S, D) in x's dtype, and with
    ``return_kv`` (out, (k, v)), k and v (B, S, KV, dh) after rotary.
    ``train=True`` takes ``dense_or_chunked_attention`` under autograd
    (``use_kernel`` unread); else ``multihead_attention``'s dispatch."""
    B, S, D = x.shape
    H, dh = cfg.n_heads, cfg.head_dim
    q, k, v = _gqa_qkv(p, cfg, x, positions)
    o = _core(q, k, v, cfg, kv_mask=kv_mask, use_kernel=use_kernel,
              train=train)
    out = o.reshape(B, S, H * dh) @ p.wo.to(x.dtype).reshape(H * dh, D)
    return (out, (k, v)) if return_kv else out


def _write_slot(cache, update, slot: int) -> None:
    """cache[:, slot] = update[:, 0], in cache's dtype, in place."""
    cache[:, slot] = update[:, 0].to(cache.dtype)


@strict_fp32()
def gqa_decode(p: Attention, cfg: LMConfig, x, cache_k, cache_v, pos: int):
    """Single-token decode. x: (B, 1, D); cache_k/v: (B, C, KV, dh); pos the
    token's position. Returns (out (B, 1, D), (cache_k, cache_v)), the
    caches written in place.

    The write slot is ``pos % C``: for a sliding window the cache is a ring
    buffer of C == window slots; otherwise C is the longest sequence, and a
    position past it wraps onto the oldest slot, as in the reference (the
    cache then acts as a window of C). The valid slots are the first
    min(pos + 1, C). Scores are float32 products of the cached values in
    x's dtype; p is rounded to x's dtype before p v, as the reference
    rounds it."""
    B, _, D = x.shape
    C = cache_k.shape[1]
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = x.dtype
    q, k, v = _gqa_qkv(p, cfg, x, torch.full((1, 1), pos, device=x.device))
    _write_slot(cache_k, k, pos % C)
    _write_slot(cache_v, v, pos % C)

    qr = q.reshape(B, 1, KV, H // KV, dh).float()
    s = torch.einsum("bqnrd,bknd->bnrqk", qr,
                     cache_k.to(dt).float()) / math.sqrt(dh)
    valid = torch.arange(C, device=x.device) < min(pos + 1, C)
    s = torch.where(valid, s, NEG_INF)
    pr = torch.softmax(s, dim=-1).to(dt)
    o = torch.einsum("bnrqk,bknd->bqnrd", pr.float(),
                     cache_v.to(dt).float()).to(dt).reshape(B, 1, H * dh)
    return o @ p.wo.to(dt).reshape(H * dh, D), (cache_k, cache_v)


# ============================================================ MLA block


def _mla_q(p: MLAttention, cfg: LMConfig, x, positions):
    """(q_nope, q_rope), (B, S, H, qk_nope) and (B, S, H, qk_rope), the
    latter after rotary."""
    m = cfg.mla
    B, S, D = x.shape
    H, qk = cfg.n_heads, m.qk_nope_dim + m.qk_rope_dim
    dt = x.dtype
    if p.wq_a is not None:
        cq = apply_norm(p.q_norm, x @ p.wq_a.to(dt))
        q = cq @ p.wq_b.to(dt).reshape(m.q_lora_rank, H * qk)
    else:
        q = x @ p.wq.to(dt).reshape(D, H * qk)
    q = q.view(B, S, H, qk)
    q_nope, q_rope = q[..., :m.qk_nope_dim], q[..., m.qk_nope_dim:]
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta, 1.0)


def _mla_latent(p: MLAttention, cfg: LMConfig, x, positions):
    """(c_kv (B, S, kv_lora) normed, k_rope (B, S, 1, qk_rope) after
    rotary): what the decode cache keeps."""
    m = cfg.mla
    kv_a = x @ p.wkv_a.to(x.dtype)
    c_kv = apply_norm(p.kv_norm, kv_a[..., :m.kv_lora_rank])
    k_rope = apply_rope(kv_a[..., m.kv_lora_rank:][:, :, None, :], positions,
                        cfg.rope_theta, 1.0)
    return c_kv, k_rope


def mla_attention(p: MLAttention, cfg: LMConfig, x, positions, *,
                  kv_mask=None, use_kernel=None, train: bool = False,
                  return_kv: bool = False):
    """Full-sequence MLA (train / prefill): decompress the latents, then
    standard multi-head attention with q and k qk_nope + qk_rope wide and v
    zero-padded to that width (sliced back after), so that one attention
    core serves it: on a CUDA tensor the kernel (dh 192 at DeepSeek's
    dims). Returns (B, S, D), and with ``return_kv`` (out, (c_kv (B, S,
    kv_lora), k_rope (B, S, qk_rope)))."""
    m = cfg.mla
    B, S, D = x.shape
    H = cfg.n_heads
    dt = x.dtype
    if positions.dim() == 1:
        positions = positions[None, :]
    q_nope, q_rope = _mla_q(p, cfg, x, positions)
    c_kv, k_rope = _mla_latent(p, cfg, x, positions)
    kv = (c_kv @ p.wkv_b.to(dt).reshape(m.kv_lora_rank, -1)).view(
        B, S, H, m.qk_nope_dim + m.v_head_dim)
    k_nope, v = kv[..., :m.qk_nope_dim], kv[..., m.qk_nope_dim:]
    k = torch.cat([k_nope, k_rope.expand(B, S, H, m.qk_rope_dim)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    qk_dim = m.qk_nope_dim + m.qk_rope_dim
    if m.v_head_dim < qk_dim:
        v = F.pad(v, (0, qk_dim - m.v_head_dim))
    o = _core(q, k, v.contiguous(), cfg, kv_mask=kv_mask,
              use_kernel=use_kernel, train=train,
              scale=1.0 / math.sqrt(qk_dim))[..., :m.v_head_dim]
    out = (o.reshape(B, S, H * m.v_head_dim)
           @ p.wo.to(dt).reshape(H * m.v_head_dim, D))
    return (out, (c_kv, k_rope[:, :, 0, :])) if return_kv else out


@strict_fp32()
def mla_decode(p: MLAttention, cfg: LMConfig, x, cache_ckv, cache_krope,
               pos: int):
    """Absorbed-matrix MLA decode against the compressed latent cache.

    cache_ckv: (B, C, kv_lora); cache_krope: (B, C, qk_rope); pos the
    token's position. Returns (out (B, 1, D), (cache_ckv, cache_krope)),
    the caches written in place. The write is at slot ``pos`` clamped to
    C - 1, as the reference's ``dynamic_update_slice_in_dim`` clamps an
    out-of-range start: past the cache's end each token overwrites the
    last slot. Slots 0..pos are valid. The k decompression is absorbed
    into the query and the v decompression applied after the mix, so
    scores and context live in the kv_lora-wide latent space."""
    m = cfg.mla
    B, _, D = x.shape
    C = cache_ckv.shape[1]
    H = cfg.n_heads
    dt = x.dtype
    posv = torch.full((1, 1), pos, device=x.device)
    q_nope, q_rope = _mla_q(p, cfg, x, posv)  # (B, 1, H, nope / rope)
    c_kv, k_rope = _mla_latent(p, cfg, x, posv)
    slot = min(pos, C - 1)
    _write_slot(cache_ckv, c_kv, slot)
    _write_slot(cache_krope, k_rope[:, :, 0, :], slot)

    wkv_b = p.wkv_b.to(dt)
    w_k, w_v = wkv_b[..., :m.qk_nope_dim], wkv_b[..., m.qk_nope_dim:]
    # absorb k's decompression into the query: (B,1,H,nope) x (lora,H,nope)
    q_lat = torch.einsum("bqhn,lhn->bqhl", q_nope.float(),
                         w_k.float()).to(dt)
    ckv = cache_ckv.to(dt).float()
    s = torch.einsum("bqhl,bsl->bhqs", q_lat.float(), ckv)
    s = s + torch.einsum("bqhr,bsr->bhqs", q_rope.float(),
                         cache_krope.to(dt).float())
    s = s / math.sqrt(m.qk_nope_dim + m.qk_rope_dim)
    valid = torch.arange(C, device=x.device) <= pos
    s = torch.where(valid, s, NEG_INF)
    pr = torch.softmax(s, dim=-1).to(dt)
    ctx_lat = torch.einsum("bhqs,bsl->bqhl", pr.float(), ckv).to(dt)
    o = torch.einsum("bqhl,lhv->bqhv", ctx_lat.float(), w_v.float()).to(dt)
    out = o.reshape(B, 1, H * m.v_head_dim) @ p.wo.to(dt).reshape(
        H * m.v_head_dim, D)
    return out, (cache_ckv, cache_krope)
