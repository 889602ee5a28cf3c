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
MAX_QT = 32     # queries a shortlist block takes (csrc/hamming.cu kMaxShortQT)
GATE_CAP = 32   # candidate slots a query (csrc/topk_board.cuh kGateCap)
# Queries a shortlist block takes in the plan: 16 up to 64 queries, 32
# above. Fewer queries a block means more blocks a query tile, so fewer
# rows a chunk and more boards to fill and merge, but more tiles reading
# the codes. chip_smoke.py times 8, 16 and 32 on the lsh engine's codes
# (PERF.md section 6 has the numbers).
TILE_QT = ((64, 16), (None, 32))
SHORTLIST_PLAN_KEYS = ("qt", "n_chunks", "rows_per_chunk", "merge_groups",
                       "smem", "blocks_per_sm", "regs")
ELEMS = 1 << 24  # (T, Q, rows, W) words a plain tile expands at most
LAUNCHES = _build.LaunchCounter("hamming")

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "hamming_launch": ([_P, _P, _I, _I, _I, _I, _P, _P], _I),
    "hamming_shortlist_launch": ([_P, _P] + [_I] * 8 + [_P] * 2 + [_I]
                                 + [_P] * 5, _I),
    "hamming_shortlist_smem": ([_I] * 3, ctypes.c_size_t),
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


def shortlist_min_blocks(tw: int) -> int:
    """Blocks an SM the shortlist kernel's register bound allows for rows
    of tw words (csrc/hamming.cu shortlist_min_blocks): four up to 16
    words, else two."""
    return 4 if tw <= 16 else 2


def shortlist_smem(qt: int, L: int, tw: int) -> int:
    """Shared memory of one shortlist block (csrc/hamming.cu
    shortlist_smem): the query tile's words and its sorted boards with
    their candidate lists and thresholds."""
    return 4 * qt * tw + qt * (_build.board_entries(L) * 8 + GATE_CAP * 8
                               + 12)


def shortlist_plan(N: int, Q: int, T: int, W: int, L: int,
                   card: dict, qt=None) -> dict:
    """The shortlist kernel's launch plan (``SHORTLIST_PLAN_KEYS``), a pure
    function of the shapes and the card (``_build.card``): query tiles of
    at most ``TILE_QT``'s size for Q, as even as Q allows; blocks an SM
    from shared memory and the register bound (``regs`` a thread); then
    row chunks of 256-row tiles that fill the card (``_build.row_chunks``)
    and the first level of their boards' merge (``_build.merge_groups``).
    ``qt`` caps the query tile instead (for a comparison on the card)."""
    if qt is None:
        qt = next(size for top, size in TILE_QT if top is None or Q <= top)
    elif not 1 <= qt <= MAX_QT:
        raise ValueError(f"hamming_shortlist: query tile {qt} not in "
                         f"1..{MAX_QT}")
    q_tiles = -(-Q // qt)
    qt = -(-Q // q_tiles)
    smem = shortlist_smem(qt, L, T * W)
    if smem > card["smem_block"]:
        raise ValueError(f"hamming_shortlist: {smem} bytes of shared memory "
                         f"a block; the card allows {card['smem_block']}")
    mb = shortlist_min_blocks(T * W)
    bps = max(1, min(mb, card["smem_sm"] // (smem + 1024)))
    n_chunks, rows_per_chunk = _build.row_chunks(N, q_tiles,
                                                 card["sms"] * bps, ROW_TILE)
    return dict(qt=qt, n_chunks=n_chunks, rows_per_chunk=rows_per_chunk,
                merge_groups=_build.merge_groups(n_chunks, Q, card["sms"]),
                smem=smem, blocks_per_sm=bps,
                regs=min(255, card["regs_sm"] // (ROW_TILE * mb)))


def hamming_shortlist_cuda(q_codes, c_codes, L: int, qt=None):
    """Launch the shortlist kernel: a partial pass over (query tile, row
    chunk) blocks, then the merge of the chunk boards, one block a query.
    Returns (dist (Q, L) int32, ids (Q, L) int32); ``qt`` caps the plan's
    query tile."""
    if L > KMAX:
        raise ValueError(f"hamming_shortlist kernel takes L <= {KMAX}, got L={L}")
    T, Q, N, W = _check(q_codes, c_codes)
    _check_l(L, N)
    q_codes, c_codes = _build.aligned(q_codes), _build.aligned(c_codes)
    dev = c_codes.device
    p = _build.cached_plan(shortlist_plan, dev, N, Q, T, W, L, qt)
    lib = _build.load("hamming", _SIGNATURES)
    n_chunks = p["n_chunks"]
    part_s = torch.empty((Q, n_chunks, L), dtype=torch.float32, device=dev)
    part_k = torch.empty((Q, n_chunks, L), dtype=torch.int32, device=dev)
    groups = p["merge_groups"]
    slice_s = torch.empty((Q, groups, L), dtype=torch.float32, device=dev)
    slice_k = torch.empty((Q, groups, L), dtype=torch.int32, device=dev)
    out_d = torch.empty((Q, L), dtype=torch.int32, device=dev)
    out_i = torch.empty((Q, L), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.hamming_shortlist_launch(
        c_codes.data_ptr(), q_codes.data_ptr(), N, Q, T, W, L, p["qt"],
        n_chunks, p["rows_per_chunk"], part_s.data_ptr(), part_k.data_ptr(),
        groups, slice_s.data_ptr(), slice_k.data_ptr(), out_d.data_ptr(),
        out_i.data_ptr(), stream)
    _build.check(lib, code, "hamming_shortlist")
    LAUNCHES.n += 1
    return out_d, out_i
