"""Bucket-resident IVF-ADC + top-k, per-query grid: the CUDA kernel
``csrc/ivf_adc.cu`` and its plain PyTorch version (port of the per-query
grid of ``repro.kernels.ivf_adc``).

Both score, for query q and visit step t (probe p = t // steps_per_probe),
every slot of block ``visit[q, t]``:
    score = sum_j lut[q(, p), j, code_j] + coarse[q, p]
summed in j order in float32, knock out slots whose id is -1, and return
the best k per query, ties to the lower visit position. They agree bit for
bit. Unfilled entries come back below NEG_INF / 2 with any id;
``ops.ivf_adc_topk`` turns them into (-inf, -1).

Table precision (``lut_dtype``), shared with the reference:
  * float32 as built;
  * bfloat16: each entry rounded once, ``x.to(torch.bfloat16).float()``,
    which equals the reference's ``reduce_precision(x, 8, 7)``
    (``repro/kernels/ops.py:188``); sums stay float32;
  * int8: per-(query(, probe), subspace) absmax scales
    (``quantize_lut_int8``); a term is float(q8) * scale, rounded, then
    added.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.distances import merge_topk, topk_scores
from repro_torch.device import kernel_path
from repro_torch.kernels import _build

NEG_INF = -1e30
KMAX = 256  # largest k the kernel's boards hold (csrc/topk_board.cuh kMaxK)
LUT_DTYPES = ("float32", "bfloat16", "int8")
LAUNCHES = _build.LaunchCounter("ivf_adc")

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "ivf_adc_launch": ([_P, _P, _P, _P, _P, _P] + [_I] * 11 + [_P] * 5, _I),
    "ivf_adc_smem_bytes": ([_I, _I, _I, _I], ctypes.c_size_t),
}


def quantize_lut_int8(luts):
    """Per-(query, subspace) absmax int8 quantization of ADC tables.

    luts: (..., m, ksub) f32 -> (lut_i8 (..., m, ksub) int8, scales (..., m)
    f32) with lut_i8 = round(lut / scale) in [-127, 127] and scale =
    max|lut_row| / 127. Rounds half to even, as jnp.round does, so the
    codes equal the reference's bit for bit.
    """
    absmax = torch.amax(torch.abs(luts), dim=-1)
    scales = (torch.clamp(absmax, min=1e-30) / 127.0).float()
    q = torch.clamp(torch.round(luts / scales[..., None]), -127.0, 127.0)
    return q.to(torch.int8), scales


def round_lut_bf16(luts):
    """bf16-rounded table values in float32 storage."""
    return luts.to(torch.bfloat16).float()


def _gather_terms(luts, lut_dtype):
    """(values, scales): float32 values whose entry j is added as is, or
    int8 values to be multiplied by scales (int8)."""
    if lut_dtype == "bfloat16":
        return round_lut_bf16(luts), None
    if lut_dtype == "int8":
        return quantize_lut_int8(luts)
    return luts.float(), None


def ivf_adc_plain(bucket_codes, bucket_ids, visit, luts, coarse, *, k: int,
                  steps_per_probe: int = 1, lut_dtype: str = "float32",
                  probe_chunk=None):
    """The kernel's function in plain PyTorch: a loop over chunks of probes,
    each one gather + sum + top-k over that chunk's blocks, folded into a
    running (Q, k) board (the reference's ``ivf_adc_topk_jnp``). The chunk
    bounds peak memory at about 32k candidate slots a query.

    bucket_codes: (B, blk, m) uint8; bucket_ids: (B, blk) int32 (-1 pad);
    visit: (Q, T) int32; luts: (Q, m, ksub) shared or (Q, nprobe, m, ksub)
    per-probe f32; coarse: (Q, nprobe) f32 -> ((Q, k) f32, (Q, k) int32).
    """
    B, blk, m = bucket_codes.shape
    Q, T = visit.shape
    spp = steps_per_probe
    nprobe = T // spp
    run = spp * blk  # candidate slots per probe
    per_probe = luts.dim() == 4
    table, scales = _gather_terms(luts, lut_dtype)
    if probe_chunk is None:
        probe_chunk = max(1, min(nprobe, 32768 // run))
    dev = visit.device
    best_s = torch.full((Q, k), NEG_INF, dtype=torch.float32, device=dev)
    best_i = torch.full((Q, k), -1, dtype=torch.int32, device=dev)
    for start in range(0, nprobe, probe_chunk):
        stop = min(start + probe_chunk, nprobe)
        pc = stop - start
        v = visit[:, start * spp:stop * spp].long()
        cp = bucket_codes[v].reshape(Q, pc, run, m).long()
        ip = bucket_ids[v].reshape(Q, pc, run)
        s = None
        for j in range(m):
            if per_probe:
                g = torch.gather(table[:, start:stop, j, :], 2, cp[..., j])
                if scales is not None:
                    g = g.float() * scales[:, start:stop, j][:, :, None]
            else:
                g = torch.gather(table[:, j, :], 1,
                                 cp[..., j].reshape(Q, pc * run))
                g = g.reshape(Q, pc, run)
                if scales is not None:
                    g = g.float() * scales[:, j][:, None, None]
            s = g if s is None else s + g
        s = s.float() + coarse[:, start:stop][:, :, None]
        s = torch.where(ip >= 0, s, NEG_INF).reshape(Q, pc * run)
        ts, pos = topk_scores(s, min(k, pc * run))
        ti = torch.gather(ip.reshape(Q, pc * run), 1, pos)
        best_s, best_i = merge_topk(best_s, best_i, ts, ti, k)
    return best_s, best_i


def _chunks(Q: int, T: int, device) -> tuple:
    """(n_chunks, steps_per_chunk): enough (query, chunk) blocks to fill
    the SMs about four times over, at least 8 visit steps (one a warp)
    a chunk."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    n = max(1, min(-(-T // 8), -(-4 * sms // Q), 65535))
    steps = -(-T // n)
    return -(-T // steps), steps


def ivf_adc_cuda(bucket_codes, bucket_ids, visit, luts, coarse, *, k: int,
                 steps_per_probe: int = 1, lut_dtype: str = "float32"):
    """Launch the kernel: the (query, chunk of visit steps) pass, then the
    merge of the chunk boards. Arguments and result as ``ivf_adc_plain``."""
    if k < 1 or k > KMAX:
        raise ValueError(f"ivf_adc kernel takes 1 <= k <= {KMAX}, got k={k}")
    if lut_dtype not in LUT_DTYPES:
        raise ValueError(f"lut_dtype must be one of {LUT_DTYPES}")
    dev = visit.device
    B, blk, m = bucket_codes.shape
    Q, T = visit.shape
    spp = steps_per_probe
    if T % spp:
        raise ValueError(f"visit width {T} is not a multiple of "
                         f"steps_per_probe={spp}")
    nprobe = T // spp
    per_probe = luts.dim() == 4
    ksub = luts.shape[-1]
    for name, t in (("bucket_codes", bucket_codes), ("bucket_ids", bucket_ids),
                    ("luts", luts), ("coarse", coarse)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, visit on {dev}")
    if tuple(coarse.shape) != (Q, nprobe):
        raise ValueError(f"coarse must be {(Q, nprobe)}")
    lut_type = LUT_DTYPES.index(lut_dtype)
    scales = None
    if lut_dtype == "int8":
        table, scales = quantize_lut_int8(luts.float())
        scales = scales.contiguous()
    elif lut_dtype == "bfloat16":
        table = luts.to(torch.bfloat16)
    else:
        table = luts.float()
    table = table.contiguous()
    codes = bucket_codes.to(torch.uint8).contiguous()
    ids = bucket_ids.to(torch.int32).contiguous()
    visit = visit.to(torch.int32).contiguous()
    coarse = coarse.float().contiguous()
    lib = _build.load("ivf_adc", _SIGNATURES)
    smem = lib.ivf_adc_smem_bytes(lut_type, m, ksub, k)
    limit = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    if smem > limit:
        raise ValueError(f"an m={m}, ksub={ksub} {lut_dtype} table with k={k} "
                         f"needs {smem} bytes of shared memory a block; the "
                         f"card allows {limit}")
    n_chunks, steps = _chunks(Q, T, dev)
    part_s = torch.empty((Q, n_chunks, k), dtype=torch.float32, device=dev)
    part_k = torch.empty((Q, n_chunks, k), dtype=torch.int32, device=dev)
    out_s = torch.empty((Q, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((Q, k), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.ivf_adc_launch(
        codes.data_ptr(), ids.data_ptr(), visit.data_ptr(), table.data_ptr(),
        None if scales is None else scales.data_ptr(), coarse.data_ptr(),
        Q, T, blk, m, ksub, spp, int(per_probe), lut_type, k, n_chunks, steps,
        part_s.data_ptr(), part_k.data_ptr(), out_s.data_ptr(),
        out_i.data_ptr(), stream)
    _build.check(lib, code, "ivf_adc")
    LAUNCHES.n += 1
    return out_s, out_i


def ivf_adc(bucket_codes, bucket_ids, visit, luts, coarse, *, k: int,
            steps_per_probe: int = 1, lut_dtype: str = "float32",
            use_kernel=None):
    """Per-query bucket-resident ADC top-k on the kernel or the plain
    version, by the device of ``visit`` (``repro_torch.device.kernel_path``)."""
    fn = ivf_adc_cuda if kernel_path(visit, use_kernel) else ivf_adc_plain
    return fn(bucket_codes, bucket_ids, visit, luts, coarse, k=k,
              steps_per_probe=steps_per_probe, lut_dtype=lut_dtype)
