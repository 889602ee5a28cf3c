"""Bucket-resident IVF-ADC + top-k: the CUDA kernels ``csrc/ivf_adc.cu``
and their plain PyTorch versions (port of ``repro.kernels.ivf_adc`` and of
the grouped grids' jnp twins in ``repro.kernels.ops``).

Three grids compute one function. For query q and visit step t (probe
p = t // steps_per_probe) they score every slot of block ``visit[q, t]``:
    score = sum_j lut[q(, p), j, code_j] + coarse[q, p]
summed in j order in float32, knock out slots whose id is -1, and return
the best k per query, ties to the lower visit position. Unfilled entries
come back below NEG_INF / 2 with any id; ``ops.ivf_adc_topk`` turns them
into (-inf, -1).

  * ``ivf_adc``: the per-query grid over the (Q, T) visit table;
  * ``ivf_adc_blocked``: one program per group of the segmented schedule
    (``core.ivf.build_block_schedule``), each a block shared by up to qblk
    (query, step) pairs;
  * ``ivf_adc_run_resident``: one program per run of the schedule, each a
    distinct block read once for the whole batch.

All three agree bit for bit, on the card and on the CPU (invariant 5 of
docs/ARCHITECTURE.md). Table precisions as in ``kernels.pq_adc``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.distances import merge_topk, topk_scores
from repro_torch.device import kernel_path
from repro_torch.kernels import _build
from repro_torch.kernels.pq_adc import LUT_DTYPES, gather_terms, kernel_table
from repro_torch.kernels.topk_distance import KMAX, NEG_INF

LAUNCHES = _build.LaunchCounter("ivf_adc")
LAUNCHES_BLOCKED = _build.LaunchCounter("ivf_adc_blocked")
LAUNCHES_RUN_RESIDENT = _build.LaunchCounter("ivf_adc_run_resident")

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "ivf_adc_launch": ([_P, _P, _P, _P, _P, _P] + [_I] * 11 + [_P] * 5, _I),
    "ivf_adc_grouped_launch": ([_P] * 11 + [_I] * 14 + [_P] * 7, _I),
    "ivf_adc_smem_bytes": ([_I, _I, _I, _I], ctypes.c_size_t),
}


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
    table, scales = gather_terms(luts, lut_dtype)
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


def _board_top_k(board_s, k: int):
    """(Q, n) board -> best k (f32 scores, positions), padded with
    (NEG_INF, -1) when k > n."""
    kk = min(k, board_s.shape[1])
    s, pos = topk_scores(board_s, kk)
    if kk < k:
        s = torch.nn.functional.pad(s, (0, k - kk), value=NEG_INF)
        pos = torch.nn.functional.pad(pos, (0, k - kk), value=-1)
    return s, pos


def _pair_scores(bucket_codes, codes_g, sched_q, sched_t, luts, coarse,
                 steps_per_probe: int, lut_dtype: str):
    """(G, qblk, blk) f32 scores of every scheduled (query, step) pair
    against its group's codes ``codes_g`` (G, blk, m): m flat table
    gathers summed in j order, then the coarse term; sentinel pairs get
    NEG_INF. The grouped twins' shared scoring core."""
    m = bucket_codes.shape[2]
    Q, nprobe = coarse.shape
    per_probe = luts.dim() == 4
    ksub = luts.shape[-1]
    table, scales = gather_terms(luts, lut_dtype)
    qs = sched_q.long().clamp(min=0)
    p_of = sched_t.long() // steps_per_probe
    n_rows = Q * nprobe if per_probe else Q
    row = qs * nprobe + p_of if per_probe else qs         # table row per pair
    table = table.reshape(n_rows, m, ksub)
    s = None
    for j in range(m):
        g = table[:, j, :].reshape(-1)[row[:, :, None] * ksub
                                       + codes_g[:, None, :, j].long()]
        if scales is not None:
            g = g.float() * scales.reshape(n_rows, m)[:, j][row][:, :, None]
        s = g if s is None else s + g                     # (G, qblk, blk)
    cpair = coarse.float().reshape(-1)[qs * nprobe + p_of]
    cpair = torch.where(sched_q >= 0, cpair, NEG_INF)     # sentinel knockout
    return s.float() + cpair[:, :, None]


def _scatter_board(s, sched_q, sched_t, Q: int, T: int):
    """Scatter (G, qblk, blk) pair scores into a (Q+1, T, blk) NEG_INF
    board at each pair's (query, step); row Q takes the sentinels."""
    blk = s.shape[2]
    qrow = torch.where(sched_q >= 0, sched_q, Q).long()
    board = torch.full((Q + 1, T, blk), NEG_INF, dtype=torch.float32,
                       device=s.device)
    board[qrow, sched_t.long()] = s
    return board, qrow


def ivf_adc_blocked_plain(bucket_codes, bucket_ids, visit, sched, luts,
                          coarse, *, k: int, steps_per_probe: int = 1,
                          lut_dtype: str = "float32"):
    """The blocked grid's function in plain PyTorch (the reference's
    ``ivf_adc_blocked_jnp``): each scheduled block gathered once per group,
    scored against its pairs, scattered into a (Q+1, T, blk) board at each
    pair's (query, step), and one top-k per query over the board in visit
    order. Pairs the schedule dropped stay at NEG_INF, the per-query grid's
    knockout.

    sched: the schedule dict of ``ops.build_schedule`` (``sb``, ``sq``,
    ``st`` used here); other arguments and result as ``ivf_adc_plain``.
    """
    Q, T = visit.shape
    sb, sq, st = sched["sb"].long(), sched["sq"], sched["st"]
    ids_g = bucket_ids[sb]                                 # (G, blk)
    s = _pair_scores(bucket_codes, bucket_codes[sb], sq, st, luts, coarse,
                     steps_per_probe, lut_dtype)
    s = torch.where(ids_g[:, None, :] >= 0, s, NEG_INF)
    board_s, qrow = _scatter_board(s, sq, st, Q, T)
    board_i = torch.full(board_s.shape, -1, dtype=torch.int32,
                         device=s.device)
    board_i[qrow, st.long()] = ids_g[:, None, :].expand(s.shape).to(torch.int32)
    bs, pos = _board_top_k(board_s[:Q].reshape(Q, -1), k)
    bi = torch.gather(board_i[:Q].reshape(Q, -1), 1, pos.clamp(min=0))
    return bs, torch.where(pos >= 0, bi, -1)


def ivf_adc_run_resident_plain(bucket_codes, bucket_ids, visit, sched, luts,
                               coarse, *, k: int, steps_per_probe: int = 1,
                               lut_dtype: str = "float32"):
    """The run-resident grid's function in plain PyTorch (the reference's
    ``ivf_adc_run_resident_jnp``): each distinct block gathered once into an
    (R, blk, m) panel that every group reads back through ``grun``; ids
    are recovered after the top-k from ``bucket_ids[visit[q, t], slot]``.

    sched: the schedule dict (``rb``, ``grun``, ``sq``, ``st`` used here);
    other arguments and result as ``ivf_adc_plain``.
    """
    Q, T = visit.shape
    blk = bucket_codes.shape[1]
    rb, grun = sched["rb"].long(), sched["grun"].long()
    sq, st = sched["sq"], sched["st"]
    codes_r = bucket_codes[rb]                             # (R, blk, m)
    valid_r = bucket_ids[rb] >= 0
    s = _pair_scores(bucket_codes, codes_r[grun], sq, st, luts, coarse,
                     steps_per_probe, lut_dtype)
    s = torch.where(valid_r[grun][:, None, :], s, NEG_INF)
    board_s, _ = _scatter_board(s, sq, st, Q, T)
    bs, pos = _board_top_k(board_s[:Q].reshape(Q, -1), k)
    safe = pos.clamp(min=0)
    blk_of = torch.gather(visit.long(), 1, safe // blk)
    bi = bucket_ids[blk_of, safe % blk]
    return bs, torch.where((bs <= 0.5 * NEG_INF) | (pos < 0), -1, bi)


def _chunks(Q: int, T: int, device) -> tuple:
    """(n_chunks, steps_per_chunk): enough (query, chunk) blocks to fill
    the SMs about four times over, at least 8 visit steps (one a warp)
    a chunk."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    n = max(1, min(-(-T // 8), -(-4 * sms // Q), 65535))
    steps = -(-T // n)
    return -(-T // steps), steps


def _kernel_inputs(bucket_codes, bucket_ids, visit, luts, coarse, k: int,
                   steps_per_probe: int, lut_dtype: str):
    """Check what every grid's kernel takes and make it contiguous:
    (codes, ids, visit, table, scales, coarse, lut_type)."""
    if k < 1 or k > KMAX:
        raise ValueError(f"ivf_adc kernel takes 1 <= k <= {KMAX}, got k={k}")
    dev = visit.device
    Q, T = visit.shape
    blk = bucket_codes.shape[1]
    if T % steps_per_probe:
        raise ValueError(f"visit width {T} is not a multiple of "
                         f"steps_per_probe={steps_per_probe}")
    if T * blk >= 2 ** 31:
        raise ValueError("ivf_adc kernel keys visit positions in int32: "
                         "T * blk < 2^31")
    for name, t in (("bucket_codes", bucket_codes), ("bucket_ids", bucket_ids),
                    ("luts", luts), ("coarse", coarse)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, visit on {dev}")
    if tuple(coarse.shape) != (Q, T // steps_per_probe):
        raise ValueError(f"coarse must be {(Q, T // steps_per_probe)}")
    table, scales = kernel_table(luts, lut_dtype)
    return (bucket_codes.to(torch.uint8).contiguous(),
            bucket_ids.to(torch.int32).contiguous(),
            visit.to(torch.int32).contiguous(), table, scales,
            coarse.float().contiguous(), LUT_DTYPES.index(lut_dtype))


def ivf_adc_cuda(bucket_codes, bucket_ids, visit, luts, coarse, *, k: int,
                 steps_per_probe: int = 1, lut_dtype: str = "float32"):
    """Launch the per-query kernel: the (query, chunk of visit steps)
    pass, then the merge of the chunk boards. Arguments and result as
    ``ivf_adc_plain``."""
    codes, ids, visit, table, scales, coarse, lut_type = _kernel_inputs(
        bucket_codes, bucket_ids, visit, luts, coarse, k, steps_per_probe,
        lut_dtype)
    dev = visit.device
    B, blk, m = codes.shape
    Q, T = visit.shape
    ksub = luts.shape[-1]
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
        Q, T, blk, m, ksub, steps_per_probe, int(luts.dim() == 4), lut_type,
        k, n_chunks, steps, part_s.data_ptr(), part_k.data_ptr(),
        out_s.data_ptr(), out_i.data_ptr(), stream)
    _build.check(lib, code, "ivf_adc")
    LAUNCHES.n += 1
    return out_s, out_i


def _grouped_cuda(bucket_codes, bucket_ids, visit, sched, luts, coarse, *,
                  k: int, steps_per_probe: int, lut_dtype: str, runs: bool):
    """Launch a grouped grid: the pair scoring (one program per schedule
    group, or per run), the per-(query, chunk) fold of the scored pairs in
    visit order, and the merge of the chunk boards."""
    codes, ids, visit, table, scales, coarse, lut_type = _kernel_inputs(
        bucket_codes, bucket_ids, visit, luts, coarse, k, steps_per_probe,
        lut_dtype)
    dev = visit.device
    B, blk, m = codes.shape
    Q, T = visit.shape
    ksub = luts.shape[-1]
    sq = sched["sq"].to(device=dev, dtype=torch.int32).contiguous()
    st = sched["st"].to(device=dev, dtype=torch.int32).contiguous()
    G, qblk = sq.shape
    if G * qblk * blk >= 2 ** 31:
        raise ValueError("ivf_adc grouped kernels index pair scores in int32:"
                         " G * qblk * blk < 2^31")
    if runs:
        block_of = sched["rb"]
        run_start = sched["rs"].to(device=dev, dtype=torch.int32).contiguous()
        run_len = sched["rl"].to(device=dev, dtype=torch.int32).contiguous()
    else:
        block_of, run_start, run_len = sched["sb"], None, None
    block_of = block_of.to(device=dev, dtype=torch.int32).contiguous()
    lib = _build.load("ivf_adc", _SIGNATURES)
    n_chunks, steps = _chunks(Q, T, dev)
    pair_s = torch.empty((G * qblk * blk,), dtype=torch.float32, device=dev)
    pair_of = torch.full((Q, T), -1, dtype=torch.int32, device=dev)
    part_s = torch.empty((Q, n_chunks, k), dtype=torch.float32, device=dev)
    part_k = torch.empty((Q, n_chunks, k), dtype=torch.int32, device=dev)
    out_s = torch.empty((Q, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((Q, k), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.ivf_adc_grouped_launch(
        codes.data_ptr(), ids.data_ptr(), visit.data_ptr(), table.data_ptr(),
        None if scales is None else scales.data_ptr(), coarse.data_ptr(),
        block_of.data_ptr(), None if run_start is None else run_start.data_ptr(),
        None if run_len is None else run_len.data_ptr(), sq.data_ptr(),
        st.data_ptr(), Q, T, blk, m, ksub, steps_per_probe,
        int(luts.dim() == 4), lut_type, k, qblk, int(runs),
        block_of.shape[0], n_chunks, steps, pair_s.data_ptr(),
        pair_of.data_ptr(), part_s.data_ptr(), part_k.data_ptr(),
        out_s.data_ptr(), out_i.data_ptr(), stream)
    _build.check(lib, code,
                 "ivf_adc_run_resident" if runs else "ivf_adc_blocked")
    return out_s, out_i


def ivf_adc_blocked_cuda(bucket_codes, bucket_ids, visit, sched, luts, coarse,
                         *, k: int, steps_per_probe: int = 1,
                         lut_dtype: str = "float32"):
    """Launch the blocked grid (one program per schedule group). Arguments
    and result as ``ivf_adc_blocked_plain``."""
    out = _grouped_cuda(bucket_codes, bucket_ids, visit, sched, luts, coarse,
                        k=k, steps_per_probe=steps_per_probe,
                        lut_dtype=lut_dtype, runs=False)
    LAUNCHES_BLOCKED.n += 1
    return out


def ivf_adc_run_resident_cuda(bucket_codes, bucket_ids, visit, sched, luts,
                              coarse, *, k: int, steps_per_probe: int = 1,
                              lut_dtype: str = "float32"):
    """Launch the run-resident grid (one program per distinct block).
    Arguments and result as ``ivf_adc_run_resident_plain``."""
    out = _grouped_cuda(bucket_codes, bucket_ids, visit, sched, luts, coarse,
                        k=k, steps_per_probe=steps_per_probe,
                        lut_dtype=lut_dtype, runs=True)
    LAUNCHES_RUN_RESIDENT.n += 1
    return out


def ivf_adc(bucket_codes, bucket_ids, visit, luts, coarse, *, k: int,
            steps_per_probe: int = 1, lut_dtype: str = "float32",
            use_kernel=None):
    """Per-query bucket-resident ADC top-k on the kernel or the plain
    version, by the device of ``visit`` (``repro_torch.device.kernel_path``)."""
    fn = ivf_adc_cuda if kernel_path(visit, use_kernel) else ivf_adc_plain
    return fn(bucket_codes, bucket_ids, visit, luts, coarse, k=k,
              steps_per_probe=steps_per_probe, lut_dtype=lut_dtype)


def ivf_adc_blocked(bucket_codes, bucket_ids, visit, sched, luts, coarse, *,
                    k: int, steps_per_probe: int = 1,
                    lut_dtype: str = "float32", use_kernel=None):
    """The blocked grid on the kernel or the plain version, by the device
    of ``visit``."""
    fn = (ivf_adc_blocked_cuda if kernel_path(visit, use_kernel)
          else ivf_adc_blocked_plain)
    return fn(bucket_codes, bucket_ids, visit, sched, luts, coarse, k=k,
              steps_per_probe=steps_per_probe, lut_dtype=lut_dtype)


def ivf_adc_run_resident(bucket_codes, bucket_ids, visit, sched, luts,
                         coarse, *, k: int, steps_per_probe: int = 1,
                         lut_dtype: str = "float32", use_kernel=None):
    """The run-resident grid on the kernel or the plain version, by the
    device of ``visit``."""
    fn = (ivf_adc_run_resident_cuda if kernel_path(visit, use_kernel)
          else ivf_adc_run_resident_plain)
    return fn(bucket_codes, bucket_ids, visit, sched, luts, coarse, k=k,
              steps_per_probe=steps_per_probe, lut_dtype=lut_dtype)
