"""Flat PQ ADC + top-k: the CUDA kernel ``csrc/pq_adc.cu`` and its plain
PyTorch version (port of ``repro.kernels.pq_adc``), and the table
precisions every ADC kernel shares.

Both score, for query q and corpus row n,
    score = sum_{j<m} lut[q, j, codes[n, j]] (+ lut[q, m, extra[n]]) + bias[n]
summed in j order in float32, and return the best k per query, ties to the
lower row id. They agree bit for bit. ``bias`` carries the knockout of a
dead or padded row (-1e30, built by ``ops.pq_adc``); ``extra`` is an
optional int32 code column, one more subspace whose table row may be
wider than 256 (IVF-PQ's ``scan_all`` folds the coarse term in that way).
Unfilled entries and knocked-out rows come back at or below NEG_INF / 2
with any id; ``ops.adc_topk`` turns them into (-inf, -1).

Table precision (``lut_dtype``), shared with the reference and with
``kernels.ivf_adc``:
  * float32 as built;
  * bfloat16: each entry rounded once, ``x.to(torch.bfloat16).float()``,
    which equals the reference's ``reduce_precision(x, 8, 7)``
    (``repro/kernels/ops.py:188``); sums stay float32;
  * int8: per-(query, subspace) absmax scales (``quantize_lut_int8``); a
    term is float(q8) * scale, rounded, then added.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.distances import merge_topk, topk_scores
from repro_torch.device import kernel_path
from repro_torch.kernels import _build
from repro_torch.kernels.topk_distance import KMAX, NEG_INF

QTS = (1, 2, 3, 4, 6, 8, 12)  # query-tile templates (csrc/pq_adc.cu)
MAX_QT = max(QTS)
THREADS = 512        # threads of a partial block, one row each (kThreads)
TILE_ROWS = THREADS  # rows a tile
SLAB = 32            # code bytes of a row in one ring stage (kSlab)
GATE_CAP = 32        # candidate slots a query (topk_board.cuh kGateCap)
LUT_DTYPES = ("float32", "bfloat16", "int8")
LUT_BYTES = {"float32": 4, "bfloat16": 2, "int8": 1}
PLAN_KEYS = ("qt", "stages", "n_chunks", "rows_per_chunk", "merge_groups",
             "smem", "blocks_per_sm", "regs")
LAUNCHES = _build.LaunchCounter("pq_adc")

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "pq_adc_launch": ([_P] * 5 + [_L] + [_I] * 9 + [_L] + [_P] * 2 + [_I]
                      + [_P] * 5, _I),
    "pq_adc_smem": ([_I] * 7, ctypes.c_size_t),
}


def quantize_lut_int8(luts):
    """Per-(query, subspace) absmax int8 quantization of ADC tables.

    luts: (..., m, ksub) f32 -> (lut_i8 (..., m, ksub) int8, scales (..., m)
    f32) with lut_i8 = round(lut / scale) in [-127, 127] and scale =
    max|lut_row| / 127. Rounds half to even, as jnp.round does, so the
    codes equal the reference's bit for bit. Shared by the flat and the
    bucket-resident kernels and their plain versions.
    """
    absmax = torch.amax(torch.abs(luts), dim=-1)
    scales = (torch.clamp(absmax, min=1e-30) / 127.0).float()
    q = torch.clamp(torch.round(luts / scales[..., None]), -127.0, 127.0)
    return q.to(torch.int8), scales


def round_lut_bf16(luts):
    """bf16-rounded table values in float32 storage."""
    return luts.to(torch.bfloat16).float()


def gather_terms(luts, lut_dtype: str):
    """(values, scales) for a plain version: float32 values whose entry is
    added as is, or int8 values to be multiplied by scales (int8)."""
    if lut_dtype == "bfloat16":
        return round_lut_bf16(luts), None
    if lut_dtype == "int8":
        return quantize_lut_int8(luts)
    return luts.float(), None


def kernel_table(luts, lut_dtype: str):
    """(table, scales) as a kernel reads them: contiguous float32, bfloat16
    or int8 entries, and float32 scales for int8 (else None)."""
    if lut_dtype not in LUT_DTYPES:
        raise ValueError(f"lut_dtype must be one of {LUT_DTYPES}")
    if lut_dtype == "int8":
        table, scales = quantize_lut_int8(luts.float())
        return table.contiguous(), scales.contiguous()
    if lut_dtype == "bfloat16":
        return luts.to(torch.bfloat16).contiguous(), None
    return luts.float().contiguous(), None


def pq_adc_plain(codes, luts, bias, *, k: int, extra=None,
                 lut_dtype: str = "float32", tile: int = 32768):
    """The kernel's function in plain PyTorch: row tiles of ``tile``, each
    m gathers summed in j order + top-k, folded into a running (Q, k)
    board, so peak memory is O(Q * tile).

    codes: (N, m) uint8; luts: (Q, m (+1 with ``extra``), W) f32; bias: (N,)
    f32; extra: optional (N,) int32 -> ((Q, k) f32, (Q, k) int32), padded
    with (NEG_INF, -1) when k > N.
    """
    N, m = codes.shape
    Q = luts.shape[0]
    table, scales = gather_terms(luts, lut_dtype)
    dev = codes.device
    best_s = torch.full((Q, k), NEG_INF, dtype=torch.float32, device=dev)
    best_i = torch.full((Q, k), -1, dtype=torch.int32, device=dev)
    cols = [(j, codes, j) for j in range(m)]
    if extra is not None:
        cols.append((m, extra[:, None], 0))
    for start in range(0, N, tile):
        stop = min(start + tile, N)
        s = None
        for j, src, c in cols:
            idx = src[start:stop, c].long()[None, :].expand(Q, -1)
            g = torch.gather(table[:, j, :], 1, idx)
            if scales is not None:
                g = g.float() * scales[:, j][:, None]
            s = g if s is None else s + g
        s = s.float() + bias[start:stop][None, :]
        ts, pos = topk_scores(s, min(k, stop - start))
        best_s, best_i = merge_topk(best_s, best_i, ts,
                                    (pos + start).to(torch.int32), k)
    return best_s, best_i


def _check(codes, luts, bias, extra, k: int):
    if k < 1 or k > KMAX:
        raise ValueError(f"pq_adc kernel takes 1 <= k <= {KMAX}, got k={k}")
    dev = codes.device
    for name, t in (("luts", luts), ("bias", bias), ("extra", extra)):
        if t is not None and t.device != dev:
            raise ValueError(f"{name} is on {t.device}, codes on {dev}")
    N, m = codes.shape
    M = m + (extra is not None)
    if luts.dim() != 3 or luts.shape[1] != M:
        raise ValueError(f"luts must be (Q, {M}, W), got {tuple(luts.shape)}")
    if tuple(bias.shape) != (N,):
        raise ValueError(f"bias must be ({N},)")
    if N >= 2 ** 31:
        raise ValueError("pq_adc kernel ids are int32: N < 2^31")


def min_blocks(qt: int) -> int:
    """Blocks an SM the kernel's register bound allows at query tile qt
    (csrc/pq_adc.cu min_blocks): two at 1 or 2 queries, else one."""
    return 2 if qt <= 2 else 1


def smem_bytes(lut_dtype: str, qt: int, m: int, has_extra: int, W: int,
               k: int, stages: int) -> int:
    """Shared memory of one partial block (csrc/pq_adc.cu partial_smem):
    the code ring, qt tables of m x min(W, 256) entries (16-byte aligned
    as a whole), int8 scales, and qt sorted boards with their candidate
    lists and thresholds."""
    tables = LUT_BYTES[lut_dtype] * qt * m * min(W, 256)
    scales = 4 * qt * (m + has_extra) if lut_dtype == "int8" else 0
    return (stages * TILE_ROWS * SLAB + -(-tables // 16) * 16 + scales
            + qt * (_build.board_entries(k) * 8 + GATE_CAP * 8 + 12))


def fit_qt(m: int, W: int, k: int, lut_dtype: str, has_extra: int,
           card: dict) -> int:
    """The largest query tile whose block fits the card's shared memory
    with a two-stage ring; raises, naming the sizes, if one query does not."""
    for qt in sorted(QTS, reverse=True):
        if smem_bytes(lut_dtype, qt, m, has_extra, W, k, 2) \
                <= card["smem_block"]:
            return qt
    raise ValueError(
        f"pq_adc: one query's m={m}, W={W} {lut_dtype} table with k={k} "
        f"needs {smem_bytes(lut_dtype, 1, m, has_extra, W, k, 2)} bytes of "
        f"shared memory a block; the card allows {card['smem_block']}")


def plan(N: int, Q: int, m: int, W: int, k: int, lut_dtype: str,
         has_extra: int, card: dict, qt=None) -> dict:
    """The kernel's launch plan (``PLAN_KEYS``), a pure function of the
    shapes and the card (``_build.card``): as few query tiles as the
    largest tile that fits allows (``fit_qt``; a block's tables serve all
    its queries for one read of the codes), each the smallest template
    that still covers Q in that many (a ragged last tile repeats a query);
    a three-stage ring where it fits; blocks an SM from shared memory and
    the register bound (``regs`` a thread); then the row chunks, and the
    first level of their boards' merge (``_build.merge_groups``). ``qt``
    forces the query tile (for a comparison on the card)."""
    if lut_dtype not in LUT_DTYPES:
        raise ValueError(f"lut_dtype must be one of {LUT_DTYPES}")
    top = fit_qt(m, W, k, lut_dtype, has_extra, card)
    if qt is None:
        q_tiles = -(-Q // top)
        qt = min(t for t in QTS if t * q_tiles >= Q)
    elif qt not in QTS or qt > top:
        raise ValueError(f"pq_adc: query tile {qt} is not one of {QTS} up to "
                         f"{top}")
    fits3 = smem_bytes(lut_dtype, qt, m, has_extra, W, k, 3) \
        <= card["smem_block"]
    stages = 3 if fits3 else 2
    smem = smem_bytes(lut_dtype, qt, m, has_extra, W, k, stages)
    bps = max(1, min(min_blocks(qt), card["smem_sm"] // (smem + 1024)))
    n_chunks, rows_per_chunk = _build.row_chunks(
        N, -(-Q // qt), card["sms"] * bps, TILE_ROWS)
    regs = card["regs_sm"] // (THREADS * min_blocks(qt))
    return dict(qt=qt, stages=stages, n_chunks=n_chunks,
                rows_per_chunk=rows_per_chunk,
                merge_groups=_build.merge_groups(n_chunks, Q, card["sms"]),
                smem=smem, blocks_per_sm=bps, regs=min(regs, 255))


def pq_adc_cuda(codes, luts, bias, *, k: int, extra=None,
                lut_dtype: str = "float32", qt=None):
    """Launch the kernel: the (query tile, row chunk) pass, then the merge
    of the chunk boards, one block a query. Arguments and result as
    ``pq_adc_plain``; ``qt`` forces the plan's query tile."""
    _check(codes, luts, bias, extra, k)
    dev = codes.device
    N, m = codes.shape
    Q, _, W = luts.shape
    lut_type = LUT_DTYPES.index(lut_dtype)
    table, scales = kernel_table(luts, lut_dtype)
    codes = _build.aligned(codes.to(torch.uint8))
    bias = bias.float().contiguous()
    if extra is not None:
        extra = extra.to(torch.int32).contiguous()
    has_extra = int(extra is not None)
    p = _build.cached_plan(plan, dev, N, Q, m, W, k, lut_dtype, has_extra,
                           qt)
    lib = _build.load("pq_adc", _SIGNATURES)
    n_chunks = p["n_chunks"]
    part_s = torch.empty((Q, n_chunks, k), dtype=torch.float32, device=dev)
    part_k = torch.empty((Q, n_chunks, k), dtype=torch.int32, device=dev)
    groups = p["merge_groups"]
    slice_s = torch.empty((Q, groups, k), dtype=torch.float32, device=dev)
    slice_k = torch.empty((Q, groups, k), dtype=torch.int32, device=dev)
    out_s = torch.empty((Q, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((Q, k), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.pq_adc_launch(
        codes.data_ptr(), None if extra is None else extra.data_ptr(),
        table.data_ptr(), None if scales is None else scales.data_ptr(),
        bias.data_ptr(), N, Q, m, W, has_extra, lut_type, k, p["qt"],
        p["stages"], n_chunks, p["rows_per_chunk"],
        part_s.data_ptr(), part_k.data_ptr(), groups, slice_s.data_ptr(),
        slice_k.data_ptr(), out_s.data_ptr(), out_i.data_ptr(), stream)
    _build.check(lib, code, "pq_adc")
    LAUNCHES.n += 1
    return out_s, out_i


def pq_adc(codes, luts, bias, *, k: int, extra=None,
           lut_dtype: str = "float32", use_kernel=None):
    """Flat ADC top-k on the kernel or the plain version, by the device of
    ``codes`` (``repro_torch.device.kernel_path``)."""
    fn = pq_adc_cuda if kernel_path(codes, use_kernel) else pq_adc_plain
    return fn(codes, luts, bias, k=k, extra=extra, lut_dtype=lut_dtype)
