"""Attention: full-sequence GQA (port of ``repro.models.attention``, the
train/prefill path the encoder runs).

On a CUDA tensor the attention core is the hand-written kernel
(``kernels.ops.flash_attention``, ``csrc/flash_attention.cu``) at every
length, the counterpart of the reference's Pallas TPU path. On a CPU tensor
(or with ``use_kernel=False``) it is the reference's rule between its two
plain versions: the materialized ``_dense_attention`` below the config's
``attn_chunk_threshold``, the online-softmax ``_chunked_attention`` (the
kernel's twin, which never holds the (Sq, Sk) scores) at and above it.
The KV-cache decode paths and MLA come with ROADMAP.md Queue 1, item 7.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import LMConfig
from repro_torch.device import kernel_path, strict_fp32
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import NEG_INF, flash_attention_plain
from repro_torch.models.layers import apply_rope, dense_init

# =================================================================== init


class Attention(nn.Module):
    """GQA projections: ``wq`` (d, h, dh), ``wk`` and ``wv`` (d, kv, dh),
    ``wo`` (h, dh, d), and with ``qkv_bias`` ``bq``, ``bk``, ``bv``."""

    def __init__(self, generator, cfg: LMConfig, dtype=torch.float32):
        super().__init__()
        if cfg.mla is not None:
            raise NotImplementedError(
                "MLA attention comes with the decode paths (ROADMAP.md Queue "
                "1, item 10); the port serves GQA encoders so far")
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


def init_attention(generator, cfg: LMConfig, dtype=torch.float32) -> Attention:
    return Attention(generator, cfg, dtype)


# ============================================================ core attention


def _dense_attention(q, k, v, *, scale, causal, window, q_offset, kv_mask=None):
    """Materialized-scores attention. q:(B,Sq,KV,rep,dh) k/v:(B,Sk,KV,dh)."""
    B, Sq, KV, rep, dh = q.shape
    o = flash_attention_plain(q.reshape(B, Sq, KV * rep, dh), k, v,
                              causal=causal, scale=scale, kv_mask=kv_mask,
                              window=window, q_offset=q_offset)
    return o.reshape(B, Sq, KV, rep, dh)


@strict_fp32()
def _chunked_attention(q, k, v, *, scale, causal, window, q_offset, q_chunk,
                       k_chunk, kv_mask=None):
    """Flash-style double loop; never materializes (Sq, Sk).

    q: (B, Sq, KV, rep, dh); k, v: (B, Sk, KV, dh). Returns (B, Sq, KV, rep, dh).
    Running max, denominator and accumulator are float32; p is rounded to
    v's dtype before the p v product, as in the reference.
    """
    B, Sq, KV, rep, dh = q.shape
    Sk = k.shape[1]
    q_chunk = min(q_chunk, Sq)
    k_chunk = min(k_chunk, Sk)
    assert Sq % q_chunk == 0 and Sk % k_chunk == 0, (Sq, q_chunk, Sk, k_chunk)
    dev = q.device
    outs = []
    for q0 in range(0, Sq, q_chunk):
        q_blk = q[:, q0:q0 + q_chunk].float()
        q_pos = q_offset + q0 + torch.arange(q_chunk, device=dev)
        m = torch.full((B, KV, rep, q_chunk), NEG_INF, device=dev)
        l = torch.zeros((B, KV, rep, q_chunk), device=dev)
        acc = torch.zeros((B, KV, rep, q_chunk, dh), device=dev)
        for k0 in range(0, Sk, k_chunk):
            k_blk = k[:, k0:k0 + k_chunk]
            v_blk = v[:, k0:k0 + k_chunk]
            k_pos = k0 + torch.arange(k_chunk, device=dev)
            s = torch.einsum("bqnrd,bknd->bnrqk", q_blk, k_blk.float()) * scale
            keep = (q_pos[:, None] >= k_pos[None, :] if causal else
                    torch.ones((q_chunk, k_chunk), dtype=torch.bool, device=dev))
            if window is not None:
                keep &= q_pos[:, None] - k_pos[None, :] < window
            s = torch.where(keep, s, NEG_INF)
            if kv_mask is not None:
                kvm = kv_mask[:, k0:k0 + k_chunk]
                s = torch.where(kvm[:, None, None, None, :], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            pv = torch.einsum("bnrqk,bknd->bnrqd", p.to(v.dtype).float(),
                              v_blk.float()).to(v.dtype)
            acc = acc * corr[..., None] + pv.float()
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        # (B, KV, rep, qc, dh) -> (B, qc, KV, rep, dh)
        outs.append(torch.movedim(out, 3, 1).to(q.dtype))
    return torch.cat(outs, dim=1)


def multihead_attention(q, k, v, cfg: LMConfig, *, causal, window, q_offset=0,
                        kv_mask=None, scale: Optional[float] = None,
                        use_kernel=None):
    """q:(B,Sq,H,dh) k/v:(B,Sk,KV,dh) -> (B,Sq,H,dh). A CUDA tensor takes
    the kernel (which raises on a window or an offset); a CPU tensor, or
    ``use_kernel=False``, the reference's dense/chunked rule."""
    B, Sq, H, dh = q.shape
    KV = k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    if kernel_path(q, use_kernel):
        if q_offset:
            raise ValueError("flash_attention kernel serves full sequences "
                             f"(q_offset 0), got q_offset={q_offset}")
        return ops.flash_attention(q, k, v, causal=causal, scale=scale,
                                   kv_mask=kv_mask, window=window,
                                   use_kernel=True)
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


# ============================================================ GQA block


def gqa_attention(p: Attention, cfg: LMConfig, x, positions, *, kv_mask=None,
                  use_kernel=None):
    """Full-sequence GQA attention. x: (B, S, D); positions: (S,) or (B, S).
    Returns (B, S, D) in x's dtype."""
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
    o = multihead_attention(q, k, v, cfg, causal=cfg.causal, window=cfg.window,
                            kv_mask=kv_mask, use_kernel=use_kernel)
    return o.reshape(B, S, H * dh) @ p.wo.to(x.dtype).reshape(H * dh, D)
