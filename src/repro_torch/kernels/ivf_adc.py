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
  * ``ivf_adc_blocked``: over the segmented schedule
    (``core.ivf.build_block_schedule``), each group a block shared by up
    to qblk (query, step) pairs;
  * ``ivf_adc_run_resident``: over the same schedule's runs, each a
    distinct block.

On the card the per-query grid (``ivf_adc_rows``) needs no schedule, no
sort and no host sync: a block takes one table row (a query, or a
(query, probe) row for per-probe tables) and the row's visit steps dealt to
its chunk (``query_plan``, ``step_owners``), stages the row's table once
and scores only the real steps, skipping the pad block's and those of
knocked-out probes on the device. The two grouped grids share one kernel
(``ivf_adc_tiles``): a block keeps the tables of a tile of ``qt`` table
rows in shared memory and streams the code blocks of the tile's scheduled
pairs past them, one fetch per (tile, group) in the blocked grid and per
(tile, run) in the run-resident grid. ``grouped_plan`` sizes the tile from
the card's shared memory; ``tile_index`` buckets the schedule's pairs by
tile (cached with the schedule). Every grid streams its code blocks
through per-warp cp.async rings, folds scores straight into per-row
boards and ends in the same two-level merge. The plain versions gather
and scatter as the reference's twins do.

All three agree bit for bit, on the card and on the CPU (invariant 5 of
docs/ARCHITECTURE.md). Table precisions as in ``kernels.pq_adc``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.core.distances import merge_topk, topk_scores
from repro_torch.device import kernel_path
from repro_torch.kernels import _build
from repro_torch.kernels.pq_adc import (LUT_BYTES, LUT_DTYPES, gather_terms,
                                        kernel_table)
from repro_torch.kernels.topk_distance import KMAX, NEG_INF

LAUNCHES = _build.LaunchCounter("ivf_adc")
LAUNCHES_BLOCKED = _build.LaunchCounter("ivf_adc_blocked")
LAUNCHES_RUN_RESIDENT = _build.LaunchCounter("ivf_adc_run_resident")

THREADS = 256   # threads of a per-query or tile block (kThreads)
WARPS = THREADS // 32
SEG_MAX = 16    # pairs one fetch serves at most (kSegMax); longer runs are cut
MAX_QT = 16     # table rows a tile holds at most
MIN_CHUNK_PAIRS = 8   # pairs a chunk at least: one a warp
CHUNK_WAVES = 2       # waves of blocks the chunks of a batch's pairs make
GROUPED_PLAN_KEYS = ("qt", "tiles", "smem", "blocks_per_sm", "slots")
MIN_CHUNK_STEPS = 32  # visit steps a per-query chunk at least: four a warp
QUERY_PLAN_KEYS = ("rows", "n_chunks", "ring", "smem", "blocks_per_sm",
                   "groups")

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "ivf_adc_launch": ([_P] * 6 + [_I] * 13 + [_P] * 8, _I),
    "ivf_adc_grouped_launch": ([_P] * 8 + [_I] * 13 + [_P] * 7, _I),
    "ivf_adc_query_smem": ([_I] * 6, ctypes.c_size_t),
    "ivf_adc_grouped_smem": ([_I] * 7, ctypes.c_size_t),
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


def _per_query_cuda(bucket_codes, bucket_ids, visit, luts, coarse, *, k: int,
                    steps_per_probe: int, lut_dtype: str, pad_block=None,
                    ring=None, walked=None):
    """Launch the per-query kernel, then the merge of each query's chunk
    boards. ``ring`` forces the code ring (True) or the direct-read variant
    (False) for comparisons on the card; ``walked``, a (Q,) int32 tensor of
    zeros, receives the visit steps the kernel scored a query. Counts no
    launch (``ivf_adc_cuda`` does)."""
    codes, ids, visit, table, scales, coarse, lut_type = _kernel_inputs(
        bucket_codes, bucket_ids, visit, luts, coarse, k, steps_per_probe,
        lut_dtype)
    codes, ids, table = (_build.aligned(x) for x in (codes, ids, table))
    dev = visit.device
    B, blk, m = codes.shape
    Q, T = visit.shape
    ksub = luts.shape[-1]
    nprobe = T // steps_per_probe
    per_probe = luts.dim() == 4
    if pad_block is not None and not 0 <= int(pad_block) < B:
        raise ValueError(f"pad_block {pad_block} is not a block id in "
                         f"0..{B - 1}")
    out_s = torch.empty((Q, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((Q, k), dtype=torch.int32, device=dev)
    if Q == 0:
        return out_s, out_i
    p = _build.cached_plan(query_plan, dev, Q, T, steps_per_probe, per_probe,
                           m, ksub, blk, k, lut_dtype, ring)
    lib = _build.load("ivf_adc", _SIGNATURES)
    n_parts = (nprobe if per_probe else 1) * p["n_chunks"]
    part_s = torch.empty((Q, n_parts, k), dtype=torch.float32, device=dev)
    part_k = torch.empty((Q, n_parts, k), dtype=torch.int32, device=dev)
    slice_s = torch.empty((Q, p["groups"], k), dtype=torch.float32,
                          device=dev)
    slice_k = torch.empty((Q, p["groups"], k), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.ivf_adc_launch(
        codes.data_ptr(), ids.data_ptr(), visit.data_ptr(), table.data_ptr(),
        None if scales is None else scales.data_ptr(), coarse.data_ptr(),
        Q, T, blk, m, ksub, steps_per_probe, int(per_probe), lut_type, k,
        p["n_chunks"], int(p["ring"]),
        -1 if pad_block is None else int(pad_block), p["groups"],
        part_s.data_ptr(), part_k.data_ptr(), slice_s.data_ptr(),
        slice_k.data_ptr(), out_s.data_ptr(), out_i.data_ptr(),
        None if walked is None else walked.data_ptr(), stream)
    _build.check(lib, code, "ivf_adc")
    return out_s, out_i


def ivf_adc_cuda(bucket_codes, bucket_ids, visit, luts, coarse, *, k: int,
                 steps_per_probe: int = 1, lut_dtype: str = "float32",
                 pad_block=None):
    """Launch the per-query grid. ``pad_block``: the all-pad block's id
    (every slot -1), whose steps the kernel skips; None walks every step.
    Other arguments and result as ``ivf_adc_plain``."""
    out = _per_query_cuda(bucket_codes, bucket_ids, visit, luts, coarse, k=k,
                          steps_per_probe=steps_per_probe,
                          lut_dtype=lut_dtype, pad_block=pad_block)
    LAUNCHES.n += 1
    return out


def _align16(x: int) -> int:
    return -(-x // 16) * 16


def tile_smem_bytes(lut_dtype: str, qt: int, m: int, ksub: int, blk: int,
                    k: int, cw: int = 1) -> int:
    """Shared memory of one grouped-grid tile block (csrc/ivf_adc.cu
    tile_layout): qt tables of m x ksub entries, each 16-byte aligned; the
    code ring, two stages a warp of one block's codes and slot ids; for
    each row a packed threshold, a sorted board, a lock, its ``cw`` coarse
    terms (nprobe for a shared table, 1 for a per-probe one) and, for
    int8, its m scales; and each warp's list of 32 candidates."""
    table = _align16(LUT_BYTES[lut_dtype] * m * ksub)
    stage = _align16(blk * m) + _align16(4 * blk)
    scales = 4 * m if lut_dtype == "int8" else 0
    return (qt * table + WARPS * 2 * stage + WARPS * 32 * 8
            + qt * (8 + 8 * _build.board_entries(k) + 4 + 4 * cw + scales))


def query_smem_bytes(lut_dtype: str, m: int, ksub: int, blk: int, k: int,
                     ring: bool) -> int:
    """Shared memory of one per-query block (csrc/ivf_adc.cu
    ivf_adc_query_smem): with the code ring, one tile row's
    (``tile_smem_bytes``) less the coarse terms, which the kernel reads
    from device memory; the direct-read variant holds only the table, the
    row's threshold, board and lock (no candidate lists; its int8 scales
    stay in device memory)."""
    if ring:
        return tile_smem_bytes(lut_dtype, 1, m, ksub, blk, k, cw=0)
    return (_align16(LUT_BYTES[lut_dtype] * m * ksub) + 8
            + 8 * _build.board_entries(k) + 4)


def query_plan(Q: int, T: int, steps_per_probe: int, per_probe: bool, m: int,
               ksub: int, blk: int, k: int, lut_dtype: str, card: dict,
               ring=None) -> dict:
    """The per-query grid's launch plan (``QUERY_PLAN_KEYS``), a pure
    function of the shapes and the card (``_build.card``), with no look at
    the data. Rows: Q table rows, or Q x nprobe with per-probe tables
    (a per-probe table changes with the probe), each with its ``steps``
    (T, or steps_per_probe). Each row's steps are cut into ``n_chunks``
    chunks, one block each: as many as keep one wave of blocks (SMs x
    blocks an SM) full, but at least MIN_CHUNK_STEPS steps a chunk, so that
    a block stages its table once for many real steps: at T = 4,096 on 132
    SMs, 128 chunks at Q = 1 (about one block an SM), 8 at Q = 32, 1 at
    Q = 512. The code ring where it fits the card's shared memory beside
    the table and the board, else the direct-read variant (``ring`` forces
    either); a size that fits neither raises. ``groups``: the first merge
    level's blocks a query (``_build.merge_groups``)."""
    if lut_dtype not in LUT_DTYPES:
        raise ValueError(f"lut_dtype must be one of {LUT_DTYPES}")
    nprobe = T // steps_per_probe
    rows = Q * nprobe if per_probe else Q
    steps = steps_per_probe if per_probe else T
    limit = card["smem_block"]
    with_ring = query_smem_bytes(lut_dtype, m, ksub, blk, k, True)
    direct = query_smem_bytes(lut_dtype, m, ksub, blk, k, False)
    if ring is None:
        ring = with_ring <= limit
    if ring and with_ring > limit or direct > limit:
        raise ValueError(
            f"ivf_adc per-query grid: an m={m}, ksub={ksub} {lut_dtype} "
            f"table with k={k} needs {direct} bytes of shared memory a "
            f"block with its board ({with_ring} with the code ring of "
            f"blk={blk}); the card allows {limit}")
    smem = with_ring if ring else direct
    bps = max(1, min(2, card["smem_sm"] // (smem + 1024)))
    n_chunks = max(1, min(card["sms"] * bps // rows,
                          steps // MIN_CHUNK_STEPS, 65535))
    n_parts = (nprobe if per_probe else 1) * n_chunks
    return dict(rows=rows, n_chunks=n_chunks, ring=bool(ring), smem=smem,
                blocks_per_sm=bps,
                groups=_build.merge_groups(n_parts, Q, card["sms"]))


def step_owners(steps: int, steps_per_probe: int, n_chunks: int) -> tuple:
    """(chunk, warp) of each of a table row's ``steps`` visit steps, as the
    per-query kernel deals them: step j of the row's probe p (of P =
    steps / steps_per_probe) goes to virtual chunk u = (j + p V // P) mod V
    of V = n_chunks x WARPS, that is to warp u // n_chunks of chunk
    u % n_chunks. Round robin within a probe, so a probe's real steps,
    which come first, spread within one of even over the chunks (and the
    warps); the probes' offsets spread what is left over."""
    V = n_chunks * WARPS
    P = steps // steps_per_probe
    s = torch.arange(steps)
    p = torch.div(s, steps_per_probe, rounding_mode="floor")
    off = torch.div(p * V, P, rounding_mode="floor")
    u = (s - p * steps_per_probe + off) % V
    return u % n_chunks, torch.div(u, n_chunks, rounding_mode="floor")


def fit_tile(m: int, ksub: int, blk: int, k: int, lut_dtype: str,
             card: dict, cw: int = 1) -> int:
    """The most table rows (up to MAX_QT) a tile block holds within the
    card's shared memory; raises, naming the sizes, if one does not fit."""
    for qt in range(MAX_QT, 0, -1):
        if tile_smem_bytes(lut_dtype, qt, m, ksub, blk, k, cw) \
                <= card["smem_block"]:
            return qt
    raise ValueError(
        f"ivf_adc grouped grids: one m={m}, ksub={ksub} {lut_dtype} table "
        f"with blk={blk}, k={k} needs "
        f"{tile_smem_bytes(lut_dtype, 1, m, ksub, blk, k, cw)} bytes of "
        f"shared memory a block; the card allows {card['smem_block']}")


def plan_width(m: int, ksub: int, blk: int, k: int, lut_dtype: str,
               card: dict, cw: int = 1) -> int:
    """The widest tile the plan takes: the most table rows with which two
    blocks still share an SM (16 warps to hide the code stream's latency;
    the kernel's register bound allows no more), else the most that fit
    one block (``fit_tile``)."""
    top = fit_tile(m, ksub, blk, k, lut_dtype, card, cw)
    two = card["smem_sm"] // 2 - 1024  # a block's share, less its reserve
    for qt in range(top, 0, -1):
        if tile_smem_bytes(lut_dtype, qt, m, ksub, blk, k, cw) <= two:
            return qt
    return top


def grouped_plan(Q: int, T: int, steps_per_probe: int, per_probe: bool,
                 m: int, ksub: int, blk: int, k: int, lut_dtype: str,
                 card: dict, qt=None) -> dict:
    """The grouped grids' launch plan (``GROUPED_PLAN_KEYS``), a pure
    function of the shapes and the card (``_build.card``): as few tiles of
    table rows (Q rows, or Q x nprobe with per-probe tables) as the widest
    tile ``plan_width`` allows, each the narrowest that still covers the
    rows in that many; blocks an SM from shared memory (two at most, the
    kernel's register bound), and so the blocks of one wave (``slots``),
    from which ``tile_index`` sizes the chunks of the batch's pairs.
    ``qt`` forces the tile width, up to the most that fit one block (for a
    comparison on the card)."""
    if lut_dtype not in LUT_DTYPES:
        raise ValueError(f"lut_dtype must be one of {LUT_DTYPES}")
    nprobe = T // steps_per_probe
    rows = Q * nprobe if per_probe else Q
    cw = 1 if per_probe else nprobe
    if qt is None:
        top = plan_width(m, ksub, blk, k, lut_dtype, card, cw)
        qt = -(-rows // -(-rows // top))
    elif not 1 <= qt <= fit_tile(m, ksub, blk, k, lut_dtype, card, cw):
        raise ValueError(
            f"ivf_adc grouped grids: tile width {qt} is not in "
            f"1..{fit_tile(m, ksub, blk, k, lut_dtype, card, cw)}")
    tiles = -(-rows // qt)
    smem = tile_smem_bytes(lut_dtype, qt, m, ksub, blk, k, cw)
    bps = max(1, min(2, card["smem_sm"] // (smem + 1024)))
    return dict(qt=qt, tiles=tiles, smem=smem, blocks_per_sm=bps,
                slots=card["sms"] * bps)


def tile_index(sched, *, rows: int, qt: int, nprobe: int,
               steps_per_probe: int, per_probe: bool, runs: bool,
               slots: int = 1) -> dict:
    """The schedule's pairs bucketed by tile of ``qt`` table rows, on the
    schedule's device, for the grouped kernel; cached in ``sched`` (which
    the plan ledger's ``ScheduleCache`` keeps), so a repeated batch skips
    it.

    One stable sort of the flat pair index on the pair's tile (row q, or
    q * nprobe + t // steps_per_probe with per-probe tables) keeps the
    schedule's block order within a tile and sends the sentinel pairs
    (q = -1) to the end, where they are dropped. A pair opens a segment
    (one fetch of its block) where its tile or its fetch unit changes --
    its schedule group (blocked) or run (``runs``) -- and every SEG_MAX
    pairs of one unit. A tile's pairs are cut into chunks of
    ``chunk_pairs``, one block each: enough for about CHUNK_WAVES waves of
    ``slots`` blocks over the batch's P pairs (at least MIN_CHUNK_PAIRS),
    so that no block holds much more than its share however unevenly the
    pairs fall on the tiles; ``n_chunks`` is the most chunks a tile needs
    (one host sync, when the index is built).

    Returns {"meta": (P, 4) int32 rows (block, query, step, opens a
    segment + 2 x probe), "tile_pairs": (tiles + 1,) int32 offsets of each
    tile's pairs, "chunk_pairs", "n_chunks"}, P = the schedule's real
    pairs.
    """
    key = (rows, qt, nprobe, steps_per_probe, per_probe, runs, slots)
    cache = sched.setdefault("tile_index", {})
    if key in cache:
        return cache[key]
    sq, st = sched["sq"], sched["st"]
    qblk = sq.shape[1]
    dev = sq.device
    P = int(sched["pairs"])
    tiles = -(-rows // qt)
    q = sq.reshape(-1).long()
    t = st.reshape(-1).long()
    row = q * nprobe + t // steps_per_probe if per_probe else q
    tile = torch.where(q >= 0, torch.div(row, qt, rounding_mode="floor"),
                       tiles)
    tile, order = torch.sort(tile, stable=True)
    tile, order = tile[:P], order[:P]
    g = torch.div(order, qblk, rounding_mode="floor")
    unit = sched["grun"].long()[g] if runs else g
    block = sched["rb"].long()[unit] if runs else sched["sb"].long()[g]
    first = torch.ones(P, dtype=torch.bool, device=dev)
    first[1:] = (tile[1:] != tile[:-1]) | (unit[1:] != unit[:-1])
    pos = torch.arange(P, device=dev)
    rank = pos - torch.cummax(torch.where(first, pos, 0), 0).values \
        if P else pos
    t = t[order]
    meta = torch.stack([block, q[order], t,
                        (rank % SEG_MAX == 0).long()
                        + 2 * torch.div(t, steps_per_probe,
                                        rounding_mode="floor")], 1)
    tile_pairs = torch.searchsorted(tile, torch.arange(tiles + 1, device=dev))
    chunk = max(MIN_CHUNK_PAIRS, math.ceil(P / (CHUNK_WAVES * slots)))
    most = int((tile_pairs[1:] - tile_pairs[:-1]).max()) if tiles else 0
    out = {"meta": meta.to(torch.int32).contiguous(),
           "tile_pairs": tile_pairs.to(torch.int32), "chunk_pairs": chunk,
           "n_chunks": max(1, -(-most // chunk))}
    cache[key] = out
    return out


def _grouped_cuda(bucket_codes, bucket_ids, visit, sched, luts, coarse, *,
                  k: int, steps_per_probe: int, lut_dtype: str, runs: bool,
                  qt=None):
    """Launch a grouped grid: the tile kernel over the pairs bucketed by
    tile (``tile_index``), then the merge of each query's boards. ``qt``
    forces the plan's tile width, for comparisons on the card; it counts
    no launch (the public wrappers below do)."""
    codes, ids, visit, table, scales, coarse, lut_type = _kernel_inputs(
        bucket_codes, bucket_ids, visit, luts, coarse, k, steps_per_probe,
        lut_dtype)
    codes, ids, table = (_build.aligned(x) for x in (codes, ids, table))
    dev = visit.device
    B, blk, m = codes.shape
    Q, T = visit.shape
    ksub = luts.shape[-1]
    nprobe = T // steps_per_probe
    per_probe = luts.dim() == 4
    if sched["sq"].numel() >= 2 ** 31:
        raise ValueError("ivf_adc grouped kernels index pairs in int32: "
                         "G * qblk < 2^31")
    p = _build.cached_plan(grouped_plan, dev, Q, T, steps_per_probe,
                           per_probe, m, ksub, blk, k, lut_dtype, qt)
    idx = tile_index(sched, rows=Q * nprobe if per_probe else Q, qt=p["qt"],
                     nprobe=nprobe, steps_per_probe=steps_per_probe,
                     per_probe=per_probe, runs=runs, slots=p["slots"])
    if idx["n_chunks"] > 65535:
        raise ValueError("ivf_adc grouped kernels: a tile needs "
                         f"{idx['n_chunks']} chunks; the grid takes 65535")
    lib = _build.load("ivf_adc", _SIGNATURES)
    n_parts = (nprobe if per_probe else 1) * idx["n_chunks"]
    groups = _build.merge_groups(n_parts, Q,
                                 p["slots"] // p["blocks_per_sm"])
    part_s = torch.empty((Q, n_parts, k), dtype=torch.float32, device=dev)
    part_k = torch.empty((Q, n_parts, k), dtype=torch.int32, device=dev)
    slice_s = torch.empty((Q, groups, k), dtype=torch.float32, device=dev)
    slice_k = torch.empty((Q, groups, k), dtype=torch.int32, device=dev)
    out_s = torch.empty((Q, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((Q, k), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.ivf_adc_grouped_launch(
        codes.data_ptr(), ids.data_ptr(), visit.data_ptr(), table.data_ptr(),
        None if scales is None else scales.data_ptr(), coarse.data_ptr(),
        idx["meta"].data_ptr(), idx["tile_pairs"].data_ptr(), Q, T, blk, m,
        ksub, steps_per_probe, int(per_probe), lut_type, k, p["qt"],
        idx["chunk_pairs"], idx["n_chunks"], groups, part_s.data_ptr(),
        part_k.data_ptr(), slice_s.data_ptr(), slice_k.data_ptr(),
        out_s.data_ptr(), out_i.data_ptr(), stream)
    _build.check(lib, code,
                 "ivf_adc_run_resident" if runs else "ivf_adc_blocked")
    return out_s, out_i


def ivf_adc_blocked_cuda(bucket_codes, bucket_ids, visit, sched, luts, coarse,
                         *, k: int, steps_per_probe: int = 1,
                         lut_dtype: str = "float32"):
    """Launch the blocked grid (a block fetched once per tile and schedule
    group). Arguments and result as ``ivf_adc_blocked_plain``."""
    out = _grouped_cuda(bucket_codes, bucket_ids, visit, sched, luts, coarse,
                        k=k, steps_per_probe=steps_per_probe,
                        lut_dtype=lut_dtype, runs=False)
    LAUNCHES_BLOCKED.n += 1
    return out


def ivf_adc_run_resident_cuda(bucket_codes, bucket_ids, visit, sched, luts,
                              coarse, *, k: int, steps_per_probe: int = 1,
                              lut_dtype: str = "float32"):
    """Launch the run-resident grid (a block fetched once per tile and
    schedule run). Arguments and result as ``ivf_adc_run_resident_plain``."""
    out = _grouped_cuda(bucket_codes, bucket_ids, visit, sched, luts, coarse,
                        k=k, steps_per_probe=steps_per_probe,
                        lut_dtype=lut_dtype, runs=True)
    LAUNCHES_RUN_RESIDENT.n += 1
    return out


def ivf_adc(bucket_codes, bucket_ids, visit, luts, coarse, *, k: int,
            steps_per_probe: int = 1, lut_dtype: str = "float32",
            pad_block=None, use_kernel=None):
    """Per-query bucket-resident ADC top-k on the kernel or the plain
    version, by the device of ``visit`` (``repro_torch.device.kernel_path``).
    The kernel skips ``pad_block``'s steps; the plain version has no need
    to, since the pad block's slots are all -1."""
    kw = dict(k=k, steps_per_probe=steps_per_probe, lut_dtype=lut_dtype)
    if kernel_path(visit, use_kernel):
        return ivf_adc_cuda(bucket_codes, bucket_ids, visit, luts, coarse,
                            pad_block=pad_block, **kw)
    return ivf_adc_plain(bucket_codes, bucket_ids, visit, luts, coarse, **kw)


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
