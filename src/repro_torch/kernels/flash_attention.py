"""Attention with a key-padding mask and a sliding window: the CUDA kernel
``csrc/flash_attention.cu`` and its plain PyTorch version (port of
``repro.kernels.flash_attention`` with its ``ops.py`` wrapper).

In the reference's layout, q (B, Sq, H, dh) and k, v (B, Sk, KV, dh) with
H a multiple of KV (GQA: query head h reads KV head h // (H // KV)):

    o = softmax(q k^T * scale, masked) v            -> (B, Sq, H, dh)

A score is set to -1e30 (the reference's NEG_INF) where ``kv_mask`` (B, Sk)
is False, where a causal row would look ahead, or outside a sliding
window (key j of row i where i - j >= window, the model's rule,
``repro.models.attention`` lines 83-84 and 128-129; the reference's
Pallas kernel has none); a fully masked row therefore averages v over all
Sk keys. Scores, softmax and the
running sums are float32; with bf16 inputs p is rounded to bf16 before the
p v product, as the reference rounds it.

``kernels.ops.flash_attention`` dispatches: a CUDA tensor launches the
kernel, a CPU tensor runs the plain version. The kernel is forward only
(as the reference's Pallas kernel has no VJP): on inputs that require a
gradient, with grad mode on, it raises instead of returning an output
that autograd cannot see through.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.device import strict_fp32
from repro_torch.kernels import _build

NEG_INF = -1e30
MAX_HEAD_DIM = 256  # csrc/flash_attention.cu: dh a multiple of 16 up to this
MAX_GRID = 65535    # B and H are grid dimensions
LAUNCHES = _build.LaunchCounter("flash_attention")
DTYPES = (torch.float32, torch.bfloat16)

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "flash_attention_launch": ([_P] * 5 + [_I] * 8 + [ctypes.c_float, _I, _P], _I),
}


@strict_fp32()
def flash_attention_plain(q, k, v, *, causal: bool, scale: float,
                          kv_mask=None, window=None, q_offset: int = 0):
    """The materialized masked softmax (the reference's
    ``_dense_attention``): float32 scores, p in q's dtype, p v summed in
    float32 and rounded to q's dtype."""
    B, Sq, H, dh = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    qr = q.reshape(B, Sq, KV, H // KV, dh).float()
    s = torch.einsum("bqnrd,bknd->bnrqk", qr, k.float()) * scale
    q_pos = q_offset + torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(Sk, device=q.device)[None, :]
    keep = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        keep &= q_pos >= k_pos
    if window is not None:
        keep &= q_pos - k_pos < window
    s = torch.where(keep, s, NEG_INF)
    if kv_mask is not None:
        s = torch.where(kv_mask[:, None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    o = torch.einsum("bnrqk,bknd->bqnrd", p.float(), v.float())
    return o.reshape(B, Sq, H, dh).to(q.dtype)


def _check(q, k, v, kv_mask, window) -> None:
    """Refuse what the kernel does not take, naming the limit."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise ValueError(
            "flash_attention kernel is forward only: its output would carry "
            "no gradient back to q, k or v. Train through "
            "models.attention.dense_or_chunked_attention (the reference's "
            "differentiable rule), or call the kernel under torch.no_grad()")
    if window is not None and (int(window) != window or window < 1):
        raise ValueError(f"flash_attention kernel takes a window of at least "
                         f"1 key, or None, got window={window}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError("flash_attention takes q (B, Sq, H, dh) and k, v "
                         "(B, Sk, KV, dh)")
    B, Sq, H, dh = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != dh or KV < 1 or H % KV:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)}: need "
                         "the same B and dh, and H a multiple of KV")
    if dh % 16 or not 16 <= dh <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention kernel takes a head dim that is a "
                         f"multiple of 16 up to {MAX_HEAD_DIM}, got dh={dh}")
    if B > MAX_GRID or H > MAX_GRID or Sq < 1 or Sk < 1:
        raise ValueError(f"flash_attention kernel takes B, H <= {MAX_GRID} "
                         f"and Sq, Sk >= 1, got {tuple(q.shape)}, Sk={Sk}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("flash_attention kernel takes q, k, v all float32 or "
                         f"all bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k, v must lie on one device")
    if kv_mask is not None and (kv_mask.shape != (B, Sk)
                                or kv_mask.dtype != torch.bool
                                or kv_mask.device != q.device):
        raise ValueError(f"kv_mask must be bool ({B}, {Sk}) on {q.device}")


def flash_attention_cuda(q, k, v, *, causal: bool, scale: float,
                         kv_mask=None, window=None):
    """Launch the kernel: (B, Sq, H, dh) in q's dtype."""
    _check(q, k, v, kv_mask, window)
    B, Sq, H, dh = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    q, k, v = _build.aligned(q), _build.aligned(k), _build.aligned(v)
    mask = None if kv_mask is None else kv_mask.contiguous()
    lib = _build.load("flash_attention", _SIGNATURES)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if mask is None else mask.data_ptr(), out.data_ptr(), B, Sq, Sk,
        H, KV, dh, int(causal), int(window or 0), float(scale),
        int(q.dtype == torch.bfloat16), stream)
    _build.check(lib, code, "flash_attention")
    LAUNCHES.n += 1
    return out
