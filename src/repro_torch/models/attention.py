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
from repro_torch.device import (bf16_exact_tf32, is_dtensor, kernel_path,
                                strict_fp32)
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
    ``multihead_attention``'s dispatch. DTensors (a sharded step) run it
    on each rank's shards (``_local_core``)."""
    if is_dtensor(q):
        return _local_core(q, k, v, cfg, kv_mask=kv_mask,
                           use_kernel=use_kernel, train=train, scale=scale)
    if train:
        return dense_or_chunked_attention(q, k, v, cfg, causal=cfg.causal,
                                          window=cfg.window, kv_mask=kv_mask,
                                          scale=scale)
    return multihead_attention(q, k, v, cfg, causal=cfg.causal,
                               window=cfg.window, kv_mask=kv_mask, scale=scale,
                               use_kernel=use_kernel)


def _local_layout(q, kv, head_dims, batch_dims):
    """The layout of a rank-local core: (q's placements, each of ``kv``'s,
    the mesh dim whose q-head split leaves the KV heads whole, or None).
    q is (B, S, H, ...); ``kv[i]`` has its batch dim ``batch_dims[i]`` and
    its KV-head dim ``head_dims[i]`` (None: no such dim), the KV heads all
    of one count KV. Batch rows stay split where q splits them. Heads stay
    split over a mesh dim that divides both H and KV (query head h reads KV
    head h // (H // KV): a rank's H / n query heads read exactly its KV / n
    KV heads), or over one that divides H when each rank's query heads fall
    in one KV group (H / n divides H // KV, danube's 32 / 8 heads on 16
    ranks): then the KV tensors stay whole and each rank reads its one KV
    head. Anything else (a partial sum, a split head_dim or sequence) is
    made whole."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = q.device_mesh
    H = q.shape[2]
    KV = next((t.shape[h] for t, h in zip(kv, head_dims) if h is not None),
              H)
    q_pl, kv_pl, group_dim = [], [[] for _ in kv], None
    for i, pl in enumerate(q.placements):
        n = mesh.size(i)
        heads = isinstance(pl, Shard) and pl.dim == 2 and H % n == 0
        if isinstance(pl, Shard) and pl.dim == 0:
            q_pl.append(Shard(0))
            dims = batch_dims
        elif heads and KV % n == 0:
            q_pl.append(Shard(2))
            dims = head_dims
        elif heads and group_dim is None and (H // KV) % (H // n) == 0:
            q_pl.append(Shard(2))
            dims = (None,) * len(kv)
            group_dim = i
        else:
            q_pl.append(Replicate())
            dims = (None,) * len(kv)
        for lst, d in zip(kv_pl, dims):
            lst.append(Replicate() if d is None else Shard(d))
    return tuple(q_pl), [tuple(pl) for pl in kv_pl], group_dim


def _on_local_shards(core, q, kv, shape, *, head_dims=None, batch_dims=None,
                     **kw):
    """``core(q, *kv, **kw)``; on DTensors (a sharded step) each rank runs
    it on its own shards, as the reference's ``shard_map`` body would: q
    and ``kv`` resharded to ``_local_layout`` (``head_dims`` and
    ``batch_dims`` default to 2 and 0 for each of ``kv``; a plain tensor
    among them counts as replicated), where each rank reads one KV head of
    whole KV tensors ``core`` gets that head, and the result is a DTensor
    of the global ``shape`` split like q. The flash kernel runs on a CUDA
    shard, never the plain version. Differentiable: ``redistribute``,
    ``to_local`` and ``from_local`` carry gradients; a KV tensor left whole
    over a mesh dim that splits q's heads gets a partial sum over it."""
    if not is_dtensor(q):
        return core(q, *kv, **kw)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from repro_torch.core.distributed import contiguous_stride, replicated
    mesh = q.device_mesh
    head_dims = head_dims or (2,) * len(kv)
    batch_dims = batch_dims or (0,) * len(kv)
    kv = [replicated(t, mesh) for t in kv]
    q_pl, kv_pl, group_dim = _local_layout(q, kv, head_dims, batch_dims)
    q = q.redistribute(mesh, q_pl)
    local = []
    for t, pl, h in zip(kv, kv_pl, head_dims):
        t = t.redistribute(mesh, pl)
        grad_pl = [Partial() if q_pl[i] == Shard(2) and p == Replicate()
                   else p for i, p in enumerate(pl)]
        loc = t.to_local(grad_placements=grad_pl)
        if group_dim is not None and h is not None:
            h_loc = q.shape[2] // mesh.size(group_dim)
            g = (mesh.get_local_rank(group_dim) * h_loc) // (
                q.shape[2] // t.shape[h])
            loc = loc.narrow(h, g, 1)
        local.append(loc)
    o = core(q.to_local(), *local, **kw).contiguous()
    return DTensor.from_local(o, mesh, q_pl, run_check=False, shape=shape,
                              stride=contiguous_stride(shape))


def _local_core(q, k, v, cfg: LMConfig, *, kv_mask, use_kernel, train,
                scale):
    """The attention core on DTensors (``_on_local_shards``): each rank
    runs ``_core`` on its own batch rows and heads; the mask (B, S_k)
    follows the batch rows."""
    def core(q, k, v, *mask):
        return _core(q, k, v, cfg, kv_mask=mask[0] if mask else None,
                     use_kernel=use_kernel, train=train, scale=scale)

    kv = (k, v) if kv_mask is None else (k, v, kv_mask)
    return _on_local_shards(core, q, kv, q.shape,
                            head_dims=(2, 2, None)[:len(kv)],
                            batch_dims=(0,) * len(kv))


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

    if _split_dims(cache_k, 3):
        o = _gqa_decode_split_dh(q, cache_k, cache_v, pos=pos, dt=dt)
        o = _heads_from_split(o, 3).reshape(B, 1, H * dh)
    else:
        o = _on_local_shards(_gqa_decode_core, q, (cache_k, cache_v),
                             (B, 1, H * dh), pos=pos, dt=dt)
    return o @ p.wo.to(dt).reshape(H * dh, D), (cache_k, cache_v)


def _gqa_decode_core(q, cache_k, cache_v, *, pos: int, dt):
    """q (B, 1, H, dh) against the caches (B, C, KV, dh) -> (B, 1, H * dh)."""
    B, _, H, dh = q.shape
    C, KV = cache_k.shape[1], cache_k.shape[2]
    qr = q.reshape(B, 1, KV, H // KV, dh).float()
    s = torch.einsum("bqnrd,bknd->bnrqk", qr,
                     cache_k.to(dt).float()) / math.sqrt(dh)
    valid = torch.arange(C, device=q.device) < min(pos + 1, C)
    s = torch.where(valid, s, NEG_INF)
    pr = torch.softmax(s, dim=-1).to(dt)
    return torch.einsum("bnrqk,bknd->bqnrd", pr.float(),
                        cache_v.to(dt).float()).to(dt).reshape(B, 1, H * dh)


def _split_dims(t, dim: int) -> list:
    """The mesh dims over which DTensor ``t`` splits its dim ``dim`` (none
    for a plain tensor)."""
    if not is_dtensor(t):
        return []
    from torch.distributed.tensor import Shard
    return [i for i, pl in enumerate(t.placements) if pl == Shard(dim)]


def _cache_layout(cache, dims: dict) -> list:
    """The placements that meet a cache shard on each rank: split where
    the cache splits its batch (dim 0) and where it splits a dim ``d`` of
    its own, at dim ``dims[d]``; whole elsewhere."""
    from torch.distributed.tensor import Replicate, Shard
    pl = []
    for cp in cache.placements:
        if cp == Shard(0):
            pl.append(Shard(0))
        elif isinstance(cp, Shard) and cp.dim in dims:
            pl.append(Shard(dims[cp.dim]))
        else:
            pl.append(Replicate())
    return pl


def _local_like(t, cache, dims: dict):
    """DTensor ``t`` redistributed to ``_cache_layout(cache, dims)``, and
    its local shard."""
    t = t.redistribute(t.device_mesh, _cache_layout(cache, dims))
    return t, t.to_local()


def _heads_from_split(o, dim: int):
    """An attention output (B, 1, H, w) split over its last dim (``dim``)
    re-split over its heads where they divide: an all-to-all of the
    output, which the output projection's heads layout reads."""
    from torch.distributed.tensor import Shard
    mesh = o.device_mesh
    pl = [Shard(2) if pl == Shard(dim) and o.shape[2] % mesh.size(i) == 0
          else pl for i, pl in enumerate(o.placements)]
    return o.redistribute(mesh, pl)


def _gqa_decode_split_dh(q, cache_k, cache_v, *, pos: int, dt):
    """``_gqa_decode_core`` where the caches' head_dim is split over mesh
    dims (their KV heads do not divide them: danube's 8 on 16 ranks): each
    rank contracts q with its k shard over its head_dim columns, the
    float32 scores are all-reduced (sum) over those dims, the scale and
    the softmax are taken locally, and its v shard gives its shard of the
    output's head_dim. Returns o (B, 1, H, dh), split as the caches split
    their batch and head_dim; q moves to that layout (an all-to-all of
    the one token's q), the caches never move."""
    from torch.distributed.tensor import DTensor

    from repro_torch.core.distributed import all_reduce_over, contiguous_stride
    mesh = q.device_mesh
    B, _, H, dh = q.shape
    C, KV = cache_k.shape[1], cache_k.shape[2]
    dims = _split_dims(cache_k, 3)
    heads = {2: 2, 3: 3}
    q, ql = _local_like(q, cache_k, heads)
    k = _local_like(cache_k, cache_k, heads)[1]
    v = _local_like(cache_v, cache_k, heads)[1]
    b, kv = ql.shape[0], k.shape[2]
    qr = ql.reshape(b, 1, kv, H // KV, ql.shape[-1]).float()
    s = all_reduce_over(torch.einsum("bqnrd,bknd->bnrqk", qr,
                                     k.to(dt).float()), "sum", mesh, dims)
    s = s / math.sqrt(dh)
    valid = torch.arange(C, device=s.device) < min(pos + 1, C)
    pr = torch.softmax(torch.where(valid, s, NEG_INF), dim=-1).to(dt)
    o = torch.einsum("bnrqk,bknd->bqnrd", pr.float(),
                     v.to(dt).float()).to(dt).reshape(ql.shape)
    return DTensor.from_local(o.contiguous(), mesh, q.placements,
                              run_check=False, shape=(B, 1, H, dh),
                              stride=contiguous_stride((B, 1, H, dh)))


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

    if _split_dims(cache_ckv, 2):
        o = _mla_decode_split_latent(q_nope, q_rope, p.wkv_b.to(dt),
                                     cache_ckv, cache_krope, pos=pos, m=m,
                                     dt=dt)
    else:
        o = _on_local_shards(_mla_decode_core,
                             torch.cat([q_nope, q_rope], dim=-1),
                             (p.wkv_b.to(dt), cache_ckv, cache_krope),
                             (B, 1, H, m.v_head_dim), head_dims=(1, None, None),
                             batch_dims=(None, 0, 0), pos=pos, m=m, dt=dt)
    out = o.reshape(B, 1, H * m.v_head_dim) @ p.wo.to(dt).reshape(
        H * m.v_head_dim, D)
    return out, (cache_ckv, cache_krope)


def _mla_decode_core(q, wkv_b, cache_ckv, cache_krope, *, pos: int, m, dt):
    """q (B, 1, H, qk_nope + qk_rope) against the latent caches -> (B, 1,
    H, v): k's decompression absorbed into the query, v's applied after
    the mix (``mla_decode``)."""
    C = cache_ckv.shape[1]
    q_nope, q_rope = q[..., :m.qk_nope_dim], q[..., m.qk_nope_dim:]
    w_k, w_v = wkv_b[..., :m.qk_nope_dim], wkv_b[..., m.qk_nope_dim:]
    # absorb k's decompression into the query: (B,1,H,nope) x (lora,H,nope)
    q_lat = torch.einsum("bqhn,lhn->bqhl", q_nope.float(),
                         w_k.float()).to(dt)
    ckv = cache_ckv.to(dt).float()
    s = torch.einsum("bqhl,bsl->bhqs", q_lat.float(), ckv)
    s = s + torch.einsum("bqhr,bsr->bhqs", q_rope.float(),
                         cache_krope.to(dt).float())
    s = s / math.sqrt(m.qk_nope_dim + m.qk_rope_dim)
    valid = torch.arange(C, device=q.device) <= pos
    s = torch.where(valid, s, NEG_INF)
    pr = torch.softmax(s, dim=-1).to(dt)
    ctx_lat = torch.einsum("bhqs,bsl->bqhl", pr.float(), ckv).to(dt)
    return torch.einsum("bqhl,lhv->bqhv", ctx_lat.float(),
                        w_v.float()).to(dt)


def _mla_decode_split_latent(q_nope, q_rope, wkv_b, cache_ckv, cache_krope,
                             *, pos: int, m, dt):
    """``_mla_decode_core`` where the latent cache's kv_lora dim is split
    over mesh dims (deepseek-v3's 512 over 16 ranks; its rope cache may
    split too): the absorbed query (each rank its heads, ``wkv_b``'s
    layout) moves to the cache's layout (an all-to-all of one token's
    query), each rank scores against its latent and rope columns, the
    float32 partial scores are all-reduced (sum), the scale and softmax
    are taken locally, the mix over its latent shard gives its columns of
    the latent context, which moves back to the heads (an all-to-all) for
    the v decompression. The caches never move. Returns (B, 1, H, v)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.core.distributed import all_reduce_over, contiguous_stride
    mesh = q_nope.device_mesh
    B, _, H, _ = q_nope.shape
    C = cache_ckv.shape[1]
    w_k, w_v = wkv_b[..., :m.qk_nope_dim], wkv_b[..., m.qk_nope_dim:]
    q_lat = torch.einsum("bqhn,lhn->bqhl", q_nope.float(),
                         w_k.float()).to(dt)
    lat_dims = _split_dims(cache_ckv, 2)
    rope_dims = _split_dims(cache_krope, 2)
    q_lat = _local_like(q_lat, cache_ckv, {2: 3})[1]
    ckv = cache_ckv.to_local().to(dt).float()
    s = torch.einsum("bqhl,bsl->bhqs", q_lat.float(), ckv)
    # the rope columns: split like the latent's (one sum for both), split
    # otherwise, or whole (each its own sum, over its own dims)
    rope_like = cache_krope if rope_dims else cache_ckv
    krope = _local_like(cache_krope, rope_like,
                        {2: 2} if rope_dims else {})[1]
    q_r = _local_like(q_rope, rope_like, {2: 3} if rope_dims else {})[1]
    s_r = torch.einsum("bqhr,bsr->bhqs", q_r.float(), krope.to(dt).float())
    if rope_dims == lat_dims:
        s = all_reduce_over(s + s_r, "sum", mesh, lat_dims)
    else:
        s = all_reduce_over(s, "sum", mesh, lat_dims) + all_reduce_over(
            s_r, "sum", mesh, rope_dims)
    s = s / math.sqrt(m.qk_nope_dim + m.qk_rope_dim)
    valid = torch.arange(C, device=s.device) <= pos
    pr = torch.softmax(torch.where(valid, s, NEG_INF), dim=-1).to(dt)
    ctx = torch.einsum("bhqs,bsl->bqhl", pr.float(), ckv).to(dt)
    shape = (B, 1, H, m.kv_lora_rank)
    ctx = DTensor.from_local(ctx.contiguous(), mesh,
                             _cache_layout(cache_ckv, {2: 3}),
                             run_check=False, shape=shape,
                             stride=contiguous_stride(shape))
    ctx = _heads_from_split(ctx, 3)
    return torch.einsum("bqhl,lhv->bqhv", ctx.float(), w_v.float()).to(dt)
