"""Hamming distance over packed LSH signatures: the CUDA kernel
``csrc/hamming.cu`` and its plain PyTorch versions (port of
``repro.kernels.hamming``).

For query codes q (T, Q, W) and corpus codes c (T, N, W), 32 bits a word:
    dist[q, n] = min over t of sum over w of popcount(q[t, q, w] ^ c[t, n, w])
Torch's uint32 lacks most arithmetic on the CPU, so codes travel as int32
bit patterns; a word with its top bit set is negative. Two functions:

  * ``hamming_*``: the (Q, N) int32 distance matrix, the TPU kernel's
    function;
  * ``hamming_shortlist_*``: the L nearest rows of each query, nearest
    first and equal distances by the lower row id (the order ``lax.top_k``
    of the negated distances gives the reference), as (dist (Q, L) int32,
    ids (Q, L) int32). The kernel selects as it scores, so the (Q, N)
    matrix never exists.

``kernels.ops.hamming`` and ``ops.hamming_shortlist`` dispatch: a CUDA
tensor launches the kernel, a CPU tensor runs the plain version. Both
kernel entries share one launch counter.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.topk_distance import KMAX

MAX_WORDS = 32  # T * W words a row may hold (csrc/hamming.cu kMaxWords)
ROW_TILE = 256  # rows a block's tile (csrc/hamming.cu kThreads)
ELEMS = 1 << 24  # (T, Q, rows, W) words a plain tile expands at most
LAUNCHES = _build.LaunchCounter("hamming")

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "hamming_launch": ([_P, _P, _I, _I, _I, _I, _P, _P], _I),
    "hamming_shortlist_launch": ([_P, _P] + [_I] * 8 + [_P] * 5, _I),
}


def popcount32(x):
    """Set bits of each 32-bit word; x holds int32 bit patterns or int64
    values in [0, 2^32). SWAR in int64, so no shift smears a sign bit."""
    v = x.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    v = v + (v >> 8)
    v = v + (v >> 16)
    return v & 0x3F


def _row_tile(T: int, Q: int, W: int) -> int:
    return max(1, ELEMS // max(1, T * Q * W))


def hamming_plain(q_codes, c_codes):
    """The kernel's function in plain PyTorch, in row tiles so that the
    (T, Q, rows, W) XOR stays under ELEMS words."""
    T, Q, W = q_codes.shape
    N = c_codes.shape[1]
    out = torch.empty((Q, N), dtype=torch.int32, device=c_codes.device)
    tile = _row_tile(T, Q, W)
    for start in range(0, N, tile):
        c = c_codes[:, start:start + tile]
        x = q_codes[:, :, None, :] ^ c[:, None, :, :]          # (T, Q, n, W)
        d = popcount32(x).sum(dim=-1)                           # (T, Q, n)
        out[:, start:start + c.shape[1]] = d.amin(dim=0).to(torch.int32)
    return out


def hamming_shortlist_plain(q_codes, c_codes, L: int, *, tile: int = 1 << 16):
    """The shortlist in plain PyTorch: row tiles of ``tile`` with a running
    merge, so peak memory is O(Q * tile). A stable ascending sort keeps the
    lower row id first among equal distances, within a tile and across the
    merge (the running set, of lower ids, comes first)."""
    N = c_codes.shape[1]
    _check_l(L, N)
    best = None
    for start in range(0, N, tile):
        d = hamming_plain(q_codes, c_codes[:, start:start + tile])
        ds, pos = torch.sort(d, dim=-1, stable=True)
        ds, ids = ds[:, :L], pos[:, :L] + start
        if best is not None:
            ds, ids = torch.cat([best[0], ds], -1), torch.cat([best[1], ids], -1)
            ds, pos = torch.sort(ds, dim=-1, stable=True)
            ds, ids = ds[:, :L], torch.gather(ids, 1, pos[:, :L])
        best = (ds, ids)
    return best[0], best[1].to(torch.int32)


def _check_l(L: int, N: int) -> None:
    if L < 1 or L > N:
        raise ValueError(f"hamming_shortlist takes 1 <= L <= N = {N}, got L={L}")


def _check(q_codes, c_codes):
    """Validate the kernel's inputs; returns (T, Q, N, W)."""
    if q_codes.dim() != 3 or c_codes.dim() != 3:
        raise ValueError("hamming takes q_codes (T, Q, W) and c_codes (T, N, W)")
    T, Q, W = q_codes.shape
    if c_codes.shape[0] != T or c_codes.shape[2] != W:
        raise ValueError(f"q_codes {tuple(q_codes.shape)} and c_codes "
                         f"{tuple(c_codes.shape)} differ in T or W")
    if T * W > MAX_WORDS:
        raise ValueError(f"hamming kernel takes T * W <= {MAX_WORDS} words a "
                         f"row, got T={T}, W={W}")
    for name, t in (("q_codes", q_codes), ("c_codes", c_codes)):
        if t.dtype != torch.int32 or t.device != c_codes.device:
            raise ValueError(f"{name} must be int32 bit patterns on "
                             f"{c_codes.device}")
    N = c_codes.shape[1]
    if N >= 2 ** 31:
        raise ValueError("hamming kernel row ids are int32")
    return T, Q, N, W


def hamming_cuda(q_codes, c_codes):
    """Launch the matrix kernel: (Q, N) int32 distances."""
    T, Q, N, W = _check(q_codes, c_codes)
    q_codes, c_codes = _build.aligned(q_codes), _build.aligned(c_codes)
    lib = _build.load("hamming", _SIGNATURES)
    out = torch.empty((Q, N), dtype=torch.int32, device=c_codes.device)
    stream = torch.cuda.current_stream(c_codes.device).cuda_stream
    code = lib.hamming_launch(c_codes.data_ptr(), q_codes.data_ptr(), N, Q, T,
                              W, out.data_ptr(), stream)
    _build.check(lib, code, "hamming")
    LAUNCHES.n += 1
    return out


def hamming_shortlist_cuda(q_codes, c_codes, L: int):
    """Launch the shortlist kernel: a partial pass over (query tile, row
    chunk) blocks, then the merge of the chunk boards. Returns (dist
    (Q, L) int32, ids (Q, L) int32)."""
    if L > KMAX:
        raise ValueError(f"hamming_shortlist kernel takes L <= {KMAX}, got L={L}")
    T, Q, N, W = _check(q_codes, c_codes)
    _check_l(L, N)
    q_codes, c_codes = _build.aligned(q_codes), _build.aligned(c_codes)
    lib = _build.load("hamming", _SIGNATURES)
    dev = c_codes.device
    qt = 8 if Q <= 8 else 32
    q_tiles = -(-Q // qt)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n_tiles = -(-N // ROW_TILE)
    n_chunks = max(1, min(n_tiles, -(-4 * sms // q_tiles), 65535))
    rows_per_chunk = ROW_TILE * -(-n_tiles // n_chunks)
    n_chunks = -(-N // rows_per_chunk)
    part_s = torch.empty((Q, n_chunks, L), dtype=torch.float32, device=dev)
    part_k = torch.empty((Q, n_chunks, L), dtype=torch.int32, device=dev)
    out_d = torch.empty((Q, L), dtype=torch.int32, device=dev)
    out_i = torch.empty((Q, L), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.hamming_shortlist_launch(
        c_codes.data_ptr(), q_codes.data_ptr(), N, Q, T, W, L, qt, n_chunks,
        rows_per_chunk, part_s.data_ptr(), part_k.data_ptr(), out_d.data_ptr(),
        out_i.data_ptr(), stream)
    _build.check(lib, code, "hamming_shortlist")
    LAUNCHES.n += 1
    return out_d, out_i

