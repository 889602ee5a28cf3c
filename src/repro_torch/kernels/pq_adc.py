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

MAX_QT = 8   # queries a block takes at most (csrc/pq_adc.cu kMaxQT)
LUT_DTYPES = ("float32", "bfloat16", "int8")
LAUNCHES = _build.LaunchCounter("pq_adc")

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "pq_adc_launch": ([_P] * 5 + [_L] + [_I] * 7 + [_I, _L] + [_P] * 5, _I),
    "pq_adc_query_smem": ([_I] * 5, ctypes.c_size_t),
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


def _query_tile(lib, lut_type: int, m: int, has_extra: int, W: int, k: int,
                Q: int, limit: int, lut_dtype: str) -> int:
    """Queries a block takes: as many tables (and boards) as fit its shared
    memory, at most MAX_QT and Q."""
    per_query = lib.pq_adc_query_smem(lut_type, m, has_extra, W, k)
    if per_query > limit:
        raise ValueError(
            f"pq_adc: one query's m={m}, W={W} {lut_dtype} table with k={k} "
            f"needs {per_query} bytes of shared memory a block; the card "
            f"allows {limit}")
    return max(1, min(MAX_QT, Q, limit // per_query))


def pq_adc_cuda(codes, luts, bias, *, k: int, extra=None,
                lut_dtype: str = "float32"):
    """Launch the kernel: the (query tile, row chunk) pass, then the merge
    of the chunk boards. Arguments and result as ``pq_adc_plain``."""
    _check(codes, luts, bias, extra, k)
    dev = codes.device
    N, m = codes.shape
    Q, _, W = luts.shape
    lut_type = LUT_DTYPES.index(lut_dtype)
    table, scales = kernel_table(luts, lut_dtype)
    codes = codes.to(torch.uint8).contiguous()
    bias = bias.float().contiguous()
    if extra is not None:
        extra = extra.to(torch.int32).contiguous()
    lib = _build.load("pq_adc", _SIGNATURES)
    props = torch.cuda.get_device_properties(dev)
    qt = _query_tile(lib, lut_type, m, int(extra is not None), W, k, Q,
                     props.shared_memory_per_block_optin, lut_dtype)
    q_tiles = -(-Q // qt)
    row_tiles = max(1, -(-N // 256))
    # enough blocks to fill the SMs twice, with at most 32k board entries
    # per query for the merge to fold
    n_chunks = max(1, min(row_tiles, -(-2 * props.multi_processor_count // q_tiles),
                          32768 // k, 65535))
    rows_per_chunk = 256 * -(-row_tiles // n_chunks)
    n_chunks = max(1, -(-N // rows_per_chunk))
    part_s = torch.empty((Q, n_chunks, k), dtype=torch.float32, device=dev)
    part_k = torch.empty((Q, n_chunks, k), dtype=torch.int32, device=dev)
    out_s = torch.empty((Q, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((Q, k), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.pq_adc_launch(
        codes.data_ptr(), None if extra is None else extra.data_ptr(),
        table.data_ptr(), None if scales is None else scales.data_ptr(),
        bias.data_ptr(), N, Q, m, W, int(extra is not None), lut_type, k, qt,
        n_chunks, rows_per_chunk, part_s.data_ptr(), part_k.data_ptr(),
        out_s.data_ptr(), out_i.data_ptr(), stream)
    _build.check(lib, code, "pq_adc")
    LAUNCHES.n += 1
    return out_s, out_i


def pq_adc(codes, luts, bias, *, k: int, extra=None,
           lut_dtype: str = "float32", use_kernel=None):
    """Flat ADC top-k on the kernel or the plain version, by the device of
    ``codes`` (``repro_torch.device.kernel_path``)."""
    fn = pq_adc_cuda if kernel_path(codes, use_kernel) else pq_adc_plain
    return fn(codes, luts, bias, k=k, extra=extra, lut_dtype=lut_dtype)
