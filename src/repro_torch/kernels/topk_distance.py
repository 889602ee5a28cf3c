"""Fused distance + top-k: the CUDA kernel ``csrc/topk_distance.cu`` and its
plain PyTorch version (port of ``repro.kernels.topk_distance``).

Both compute, for queries q (Q, d) against corpus rows c (N, d):
    score[q, n] = (2 if l2 else 1) * q.c + bias[n]
and return the best k per query, best first, ties to the lower row id.
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
    "topk_distance_launch": ([_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                              _P, _P, _P, _P, _P], _I),
}


@strict_fp32()
def topk_distance_plain(corpus, q, bias, *, k: int, l2: bool,
                        tile: int = 1 << 20):
    """The kernel's function in plain PyTorch, scanning the corpus in row
    tiles of ``tile`` with a running top-k so peak memory is O(Q * tile)."""
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
    if k < 1 or k > KMAX:
        raise ValueError(
            f"topk_distance kernel takes 1 <= k <= {KMAX}, got k={k}")
    for name, t in (("corpus", corpus), ("q", q), ("bias", bias)):
        if t.dtype != torch.float32 or t.device != corpus.device:
            raise ValueError(f"{name} must be float32 on {corpus.device}")
    if corpus.shape[0] >= 2 ** 31:
        raise ValueError("topk_distance kernel ids are int32")


def topk_distance_cuda(corpus, q, bias, *, k: int, l2: bool):
    """Launch the kernel: a partial pass over (query tile, corpus chunk)
    blocks, then the merge of the chunk boards. Returns (Q, k) f32 scores
    and int32 ids; an unfilled slot is (-inf, -1)."""
    _check(corpus, q, bias, k)
    corpus, q, bias = corpus.contiguous(), q.contiguous(), bias.contiguous()
    N, d = corpus.shape
    Q = q.shape[0]
    lib = _build.load("topk_distance", _SIGNATURES)
    dev = corpus.device
    tm = 1 if Q <= 16 else 4
    bq = 16 * tm
    q_tiles = -(-Q // bq)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n_tiles = -(-N // 64)
    n_chunks = max(1, min(n_tiles, -(-4 * sms // q_tiles), 65535))
    rows_per_chunk = 64 * -(-n_tiles // n_chunks)
    n_chunks = -(-N // rows_per_chunk)
    part_s = torch.empty((Q, n_chunks, k), dtype=torch.float32, device=dev)
    part_k = torch.empty((Q, n_chunks, k), dtype=torch.int32, device=dev)
    out_s = torch.empty((Q, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((Q, k), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.topk_distance_launch(
        corpus.data_ptr(), q.data_ptr(), bias.data_ptr(), N, Q, d, k,
        int(l2), tm, n_chunks, rows_per_chunk, part_s.data_ptr(),
        part_k.data_ptr(), out_s.data_ptr(), out_i.data_ptr(), stream)
    _build.check(lib, code, "topk_distance")
    LAUNCHES.n += 1
    return out_s, out_i


def topk_distance(corpus, q, bias, *, k: int, l2: bool = False,
                  use_kernel=None):
    """corpus: (N, d); q: (Q, d); bias: (N,) -> (scores (Q, k) f32,
    ids (Q, k) int32), before the wrapper's -|q|^2 for l2."""
    if kernel_path(corpus, use_kernel):
        return topk_distance_cuda(corpus, q, bias, k=k, l2=l2)
    return topk_distance_plain(corpus, q, bias, k=k, l2=l2)
