"""Fused distance + top-k: the CUDA kernel ``csrc/topk_distance.cu`` and its
plain PyTorch version (port of ``repro.kernels.topk_distance``).

Both compute, for queries q (Q, d) against corpus rows c (N, d):
    score[q, n] = (2 if l2 else 1) * q.c + bias[n]
and return the best k per query, best first, ties to the lower row id.
The corpus and q are both float32 or both bf16; a bf16 pair is scored as
products of the bf16 values (exact in float32) summed in float32, as the
reference's kernel upcasts a bf16 tile.
``bias`` carries the metric term (-|c|^2 for l2) and the knockout (-1e30
for a dead or padded row); ``ops.topk_distance`` builds it and subtracts
|q|^2 for l2. A CUDA tensor launches the kernel, a CPU tensor runs the
plain version (``repro_torch.device.kernel_path``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.distances import merge_topk, topk_scores
from repro_torch.device import kernel_path, strict_fp32
from repro_torch.kernels import _build

NEG_INF = -1e30
KMAX = 256  # largest k the kernel's boards hold (csrc/topk_board.cuh kMaxK)
LAUNCHES = _build.LaunchCounter("topk_distance")

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "topk_distance_config": ([_I] * 6 + [_P], _I),
    "topk_distance_launch": ([_P, _P, _P] + [_I] * 11 + [_P] * 5, _I),
}
PLAN_KEYS = ("bq", "resident", "stages", "n_chunks", "rows_per_chunk", "smem",
             "blocks_per_sm")
_plans: dict = {}  # (N, Q, d, k, dtype, resident, device) -> plan
DTYPES = (torch.float32, torch.bfloat16)  # the corpus types the kernel takes


@strict_fp32()
def topk_distance_plain(corpus, q, bias, *, k: int, l2: bool,
                        tile: int = 1 << 20):
    """The kernel's function in plain PyTorch, scanning the corpus in row
    tiles of ``tile`` with a running top-k so peak memory is O(Q * tile).
    A bf16 corpus and q are scored as the kernel scores them: products of
    the bf16 values (exact in float32) summed in float32."""
    N = corpus.shape[0]
    best = None
    for start in range(0, N, tile):
        stop = min(start + tile, N)
        s = q.float() @ corpus[start:stop].float().T
        if l2:
            s = 2.0 * s
        s = s + bias[start:stop][None, :]
        ts, ti = topk_scores(s, min(k, stop - start))
        ti = ti + start
        best = (ts, ti) if best is None else merge_topk(*best, ts, ti, k)
    s, i = best
    return s, i.to(torch.int32)


def _check(corpus, q, bias, k: int):
    """Refuse what the kernel does not take, naming the limit."""
    if k < 1 or k > KMAX:
        raise ValueError(
            f"topk_distance kernel takes 1 <= k <= {KMAX}, got k={k}")
    if corpus.dtype not in DTYPES or q.dtype != corpus.dtype:
        raise ValueError("topk_distance kernel takes a float32 or bfloat16 "
                         "corpus and q of the same type, got "
                         f"{corpus.dtype} and {q.dtype}")
    if bias.dtype != torch.float32:
        raise ValueError(f"bias must be float32, got {bias.dtype}")
    if q.device != corpus.device or bias.device != corpus.device:
        raise ValueError(f"corpus, q and bias must lie on {corpus.device}")
    if corpus.dim() != 2 or q.dim() != 2 or q.shape[1] != corpus.shape[1] \
            or bias.shape != (corpus.shape[0],):
        raise ValueError(f"corpus (N, d), q (Q, d) and bias (N,), got "
                         f"{tuple(corpus.shape)}, {tuple(q.shape)}, "
                         f"{tuple(bias.shape)}")
    d = corpus.shape[1]
    if d < 8 or d % 8:
        raise ValueError("topk_distance kernel takes d a multiple of 8 "
                         f"(16-byte rows in bf16), got d={d}")
    if corpus.shape[0] >= 2 ** 31:
        raise ValueError("topk_distance kernel ids are int32: N < 2^31, got "
                         f"N={corpus.shape[0]}")
    if corpus.shape[0] < 1 or q.shape[0] < 1:
        raise ValueError("topk_distance kernel takes N >= 1 and Q >= 1")


def plan(N: int, Q: int, d: int, k: int, dtype=torch.float32,
         resident=None) -> dict:
    """The kernel's launch plan on the current card (``PLAN_KEYS``): query
    rows a block (``bq``: 16, 32, 64 or 128), whether the query tile stays
    in shared memory (``resident``; None lets the plan choose), the ring's
    stages, the corpus chunks, rows a chunk, shared memory bytes a block
    and blocks an SM. Cached per shape."""
    key = (N, Q, d, k, dtype, resident, torch.cuda.current_device())
    got = _plans.get(key)
    if got is None:
        lib = _build.load("topk_distance", _SIGNATURES)
        cfg = (ctypes.c_int * len(PLAN_KEYS))()
        code = lib.topk_distance_config(
            N, Q, d, k, int(dtype == torch.bfloat16),
            -1 if resident is None else int(resident),
            ctypes.cast(cfg, ctypes.c_void_p))
        _build.check(lib, code, "topk_distance plan")
        got = _plans[key] = dict(zip(PLAN_KEYS, list(cfg)))
    return got


def topk_distance_cuda(corpus, q, bias, *, k: int, l2: bool, resident=None):
    """Launch the kernel: a partial pass over (query tile, corpus chunk)
    blocks, then the merge of the chunk boards. Returns (Q, k) f32 scores
    and int32 ids; an unfilled slot is (-inf, -1). ``resident`` forces the
    query tile's placement (``plan``); None lets the plan choose."""
    _check(corpus, q, bias, k)
    corpus, q, bias = (_build.aligned(t) for t in (corpus, q, bias))
    N, d = corpus.shape
    Q = q.shape[0]
    lib = _build.load("topk_distance", _SIGNATURES)
    dev = corpus.device
    p = plan(N, Q, d, k, corpus.dtype, resident)
    n_chunks = p["n_chunks"]
    part_s = torch.empty((Q, n_chunks, k), dtype=torch.float32, device=dev)
    part_k = torch.empty((Q, n_chunks, k), dtype=torch.int32, device=dev)
    out_s = torch.empty((Q, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((Q, k), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.topk_distance_launch(
        corpus.data_ptr(), q.data_ptr(), bias.data_ptr(), N, Q, d, k,
        int(l2), int(corpus.dtype == torch.bfloat16), p["bq"], p["resident"],
        p["stages"], n_chunks, p["rows_per_chunk"], part_s.data_ptr(),
        part_k.data_ptr(), out_s.data_ptr(), out_i.data_ptr(), stream)
    _build.check(lib, code, "topk_distance")
    LAUNCHES.n += 1
    return out_s, out_i


def topk_distance(corpus, q, bias, *, k: int, l2: bool = False,
                  use_kernel=None):
    """corpus: (N, d); q: (Q, d) of the corpus's type (float32 or bf16);
    bias: (N,) f32 -> (scores (Q, k) f32, ids (Q, k) int32), before the
    wrapper's -|q|^2 for l2."""
    if kernel_path(corpus, use_kernel):
        return topk_distance_cuda(corpus, q, bias, k=k, l2=l2)
    return topk_distance_plain(corpus, q, bias, k=k, l2=l2)
