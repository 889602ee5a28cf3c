"""Public wrappers around the port's kernels (port of
``repro.kernels.ops``, the parts the exact, PQ, IVF-PQ and LSH engines
and the text encoder use).

Each wrapper prepares the kernel's inputs and dispatches on the tensor's
device (``repro_torch.device.kernel_path``): a CUDA tensor launches the
hand-written kernel, a CPU tensor runs its plain PyTorch version.
``use_kernel=True`` forces the kernel (and raises on a CPU tensor);
``use_kernel=False`` forces the plain version, which only the
kernel-against-plain comparisons use.

``ivf_adc_topk`` also picks one of three grids that give the same ids and
scores bit for bit: the per-query grid, the blocked grid over the
segmented block schedule (``core.ivf.build_block_schedule``) and the
run-resident grid over the same schedule's runs. ``mode="auto"`` (the
default, as in the reference) asks the measured autotuner
(``kernels.autotune``).
"""
from __future__ import annotations

import math
import time

import torch

from repro_torch.core.ivf import build_block_schedule, visit_sharing
from repro_torch.device import kernel_path
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import hamming as _hm
from repro_torch.kernels import ivf_adc as _ivf
from repro_torch.kernels import pq_adc as _pq
from repro_torch.kernels import topk_distance as _tk
from repro_torch.kernels.autotune import LEDGER
from repro_torch.kernels.topk_distance import NEG_INF

ADC_LUT_DTYPES = _pq.LUT_DTYPES
ADC_MODES = ("auto", "blocked", "per_query", "run_resident")
LAUNCH_COUNTERS = (_tk.LAUNCHES, _pq.LAUNCHES, _ivf.LAUNCHES,
                   _ivf.LAUNCHES_BLOCKED, _ivf.LAUNCHES_RUN_RESIDENT,
                   _hm.LAUNCHES, _fa.LAUNCHES)

# The untuned dispatch constants of the grouped grids, used only with
# ``autotune=False``; the board bound caps the grouped plain versions'
# (Q+1, T, blk) scatter board on every path, as in the reference.
BLOCKED_MIN_SHARING = 2.0
BLOCKED_MIN_QUERIES = 32
BLOCKED_MAX_BOARD_SLOTS = 1 << 25
DEFAULT_QBLK = 8


def launch_counts() -> dict:
    """{kernel name: launches since the last reset}."""
    return {c.name: c.n for c in LAUNCH_COUNTERS}


def reset_launch_counts() -> None:
    for c in LAUNCH_COUNTERS:
        c.reset()


def normalize_knockouts(s, i):
    """Anything at or below NEG_INF/2 (a knocked-out or unfilled slot) ->
    (-inf, -1); real scores live many orders of magnitude above."""
    bad = s <= 0.5 * NEG_INF
    return torch.where(bad, -torch.inf, s), torch.where(bad, -1, i)


def topk_distance(corpus, q, *, k: int, metric: str = "dot", corpus_sq=None,
                  valid=None, use_kernel=None):
    """Fused exact top-k. corpus: (N, d) float32 or bf16; q: (Q, d), cast
    to the corpus's dtype; metric in {dot, l2}.

    Rows where ``valid`` is False are knocked out through the additive
    score bias (-1e30), as in the reference. Returns (scores (Q, k) f32,
    ids (Q, k) int32) as the kernel leaves them: a knocked-out row can
    still appear, near -1e30, when fewer than k rows are live.
    """
    N = corpus.shape[0]
    l2 = metric == "l2"
    if l2:
        if corpus_sq is None:
            corpus_sq = torch.sum(torch.square(corpus.float()), dim=-1)
        bias = -corpus_sq.float()
    else:
        bias = torch.zeros((N,), dtype=torch.float32, device=corpus.device)
    if valid is not None:
        bias = torch.where(valid, bias, NEG_INF)
    q = q.to(corpus.dtype)
    s, i = _tk.topk_distance(corpus, q, bias, k=k, l2=l2,
                             use_kernel=use_kernel)
    if l2:
        s = s - torch.sum(torch.square(q.float()), dim=-1, keepdim=True)
    return s, i


def pq_adc(codes, luts, *, k: int, valid=None, extra_codes=None,
           lut_dtype: str = "float32", use_kernel=None):
    """Fused PQ ADC top-k. codes: (N, m) uint8-valued; luts: (Q, m, ksub),
    or (Q, m + 1, W) with ``extra_codes`` (N,) int32 indexing the last
    table row.

    Rows where ``valid`` is False are knocked out through the additive
    score bias (-1e30), as in the reference's wrapper. Returns the kernel's
    (scores (Q, k) f32, ids (Q, k) int32): knocked-out rows and unfilled
    slots sit at or below NEG_INF / 2.
    """
    N = codes.shape[0]
    bias = torch.zeros((N,), dtype=torch.float32, device=codes.device)
    if valid is not None:
        bias = torch.where(valid, bias, NEG_INF)
    return _pq.pq_adc(codes, luts.float(), bias, k=k, extra=extra_codes,
                      lut_dtype=lut_dtype, use_kernel=use_kernel)


def adc_topk(codes, luts, *, k: int, valid=None, extra_codes=None,
             lut_dtype: str = "float32", use_kernel=None):
    """PQ ADC top-k, the flat compressed hot path: ``pq_adc`` with
    knocked-out and unfilled slots normalized to (-inf, -1), the sentinel
    every engine reads."""
    if lut_dtype not in ADC_LUT_DTYPES:
        raise ValueError(f"lut_dtype {lut_dtype!r} not in {ADC_LUT_DTYPES}")
    s, i = pq_adc(codes, luts, k=k, valid=valid, extra_codes=extra_codes,
                  lut_dtype=lut_dtype, use_kernel=use_kernel)
    return normalize_knockouts(s, i)


def build_schedule(visit, *, qblk: int, pad_block=None) -> dict:
    """The grouped grids' inputs for one visit table: the segmented
    schedule (``sb``, ``sq``, ``st``), its runs (``rb``, ``rs``, ``rl``),
    the group -> run map ``grun``, and the real pair, group and run
    counts. The grouped kernels add their pair index by tile
    (``kernels.ivf_adc.tile_index``) under ``tile_index``."""
    sb, sq, st, s2 = build_block_schedule(visit, qblk=qblk,
                                          pad_block=pad_block)
    rb, rs, rl = s2["runs"]
    return {"sb": sb, "sq": sq, "st": st, "rb": rb, "rs": rs, "rl": rl,
            "grun": s2["grun"], "pairs": s2["pairs"],
            "groups": s2["groups"], "n_runs": s2["n_runs"]}


def _build_schedule_cached(visit, qblk, pad_block, cache, base_key, Q, T):
    """Build the schedule for one (visit table, qblk), or take it from the
    plan ledger's ``ScheduleCache``; a hit skips the sort and is checked
    against the visit table itself, so a stale entry cannot alias."""
    key = (base_key, qblk,
           None if pad_block is None else int(pad_block), Q, T)
    if cache is not None:
        hit = cache.get(key, visit)
        if hit is not None:
            return hit
    built = build_schedule(visit, qblk=qblk, pad_block=pad_block)
    if cache is not None:
        cache.put(key, visit, built)
    return built


def _synchronize(x) -> None:
    if x.is_cuda:
        torch.cuda.synchronize(x.device)


def ivf_adc_topk(bucket_codes, bucket_ids, visit, luts, *, k: int,
                 coarse=None, steps_per_probe: int = 1, use_kernel=None,
                 lut_dtype: str = "float32", mode: str = "auto", qblk=None,
                 pad_block=None, stats=None, autotune=None,
                 sched_cache=None, sched_key=()):
    """Bucket-resident IVF-ADC top-k, the IVF-PQ hot path. Work scales
    with the probed candidate count, not N.

    bucket_codes: (B, blk, m) uint8 codes in the block-aligned bucket-major
    layout (row b of ``bucket_ids`` names the global row each slot holds,
    -1 = pad; see ``repro_torch.core.ivf.BlockListLayout``); visit: (Q, T)
    int32 block ids with T = nprobe * steps_per_probe; luts: (Q, m, ksub)
    shared tables (dot) or (Q, nprobe, m, ksub) per-probe tables (l2);
    ``coarse``: optional (Q, nprobe) f32 additive per-probe term, also a
    probe knockout when an entry is NEG_INF.

    ``mode`` picks the grid: 'per_query' (each query's visit row walked
    on the device, ``pad_block``'s steps skipped), 'blocked' (the visit
    table's pairs sorted into groups of ``qblk`` that share a block, with
    ``pad_block``'s pairs dropped), 'run_resident' (each distinct block
    once for the batch), or 'auto'. ``pad_block``: the all-pad block
    (every slot -1), or None. 'auto' reads the cheap sharing probe
    (``visit_sharing``) and asks the measured autotuner (``LEDGER``, or
    the ``AutoTuner`` passed as ``autotune``) for the grid; while a key is
    still being measured, each batch times one candidate grid as it is
    served, a grouped grid's schedule and pair index included where the
    schedule cache misses.
    ``autotune=False`` uses the untuned constants instead. A grouped grid
    runs only where the (Q+1, T, blk) board fits BLOCKED_MAX_BOARD_SLOTS,
    as in the reference. ``sched_cache``/``sched_key``: the plan ledger's
    ``ScheduleCache`` and its (bucket, generation, nprobe) context, so
    repeated batches skip the sort. ``stats`` (a dict) receives the
    decision: 'mode', 'sharing', 'pairs', 'blocks', 'groups', 'qblk',
    'probe', 'crossover'.

    Returns (scores (Q, k) f32, ids (Q, k) int32) with knocked-out and
    unfilled slots as (-inf, -1), the same from every grid.
    """
    if lut_dtype not in ADC_LUT_DTYPES:
        raise ValueError(f"lut_dtype {lut_dtype!r} not in {ADC_LUT_DTYPES}")
    if mode not in ADC_MODES:
        raise ValueError(f"mode {mode!r} not in {ADC_MODES}")
    Q, T = visit.shape
    if coarse is None:
        coarse = torch.zeros((Q, T // steps_per_probe), dtype=torch.float32,
                             device=visit.device)
    backend = "cuda" if kernel_path(visit, use_kernel) else "plain"
    blk, m = bucket_codes.shape[1], bucket_codes.shape[2]
    sstats = {"mode": "per_query", "sharing": 0.0, "pairs": 0, "blocks": 0,
              "groups": 0, "qblk": 0, "probe": False, "crossover": None}
    grid = "per_query"
    eff_qblk = DEFAULT_QBLK if qblk is None else qblk
    probe_cfg = tuner = tkey = None
    if mode != "per_query":
        sstats.update(visit_sharing(visit, pad_block=pad_block))
        board_ok = (Q + 1) * T * blk <= BLOCKED_MAX_BOARD_SLOTS
        if mode != "auto":
            grid = mode
        elif autotune is False:
            if (Q >= BLOCKED_MIN_QUERIES and board_ok
                    and sstats["sharing"] >= BLOCKED_MIN_SHARING):
                grid = "blocked"
        else:
            tuner = LEDGER if autotune is None else autotune
            tkey = (backend, m, luts.shape[-1], blk, lut_dtype)
            entry = tuner.lookup(tkey)
            if entry is not None:
                sstats["crossover"] = entry["crossover"]
                if (sstats["pairs"] > 0 and board_ok
                        and sstats["sharing"] >= entry["crossover"]):
                    grid = entry["grouped_mode"]
                    eff_qblk = entry["qblk"] if qblk is None else qblk
            elif sstats["pairs"] > 0 and board_ok:
                probe_cfg = tuner.next_probe(tkey)
                if probe_cfg is not None:
                    grid = probe_cfg[0]
                    if probe_cfg[1]:
                        eff_qblk = probe_cfg[1]
                    sstats["probe"] = True
    kw = dict(k=k, steps_per_probe=steps_per_probe, lut_dtype=lut_dtype,
              use_kernel=use_kernel)

    def _schedule():
        return _build_schedule_cached(visit, eff_qblk, pad_block,
                                      sched_cache, sched_key, Q, T)

    def _run(g, sched):
        if g == "per_query":
            return _ivf.ivf_adc(bucket_codes, bucket_ids, visit, luts, coarse,
                                pad_block=pad_block, **kw)
        fn = _ivf.ivf_adc_blocked if g == "blocked" else _ivf.ivf_adc_run_resident
        return fn(bucket_codes, bucket_ids, visit, sched, luts, coarse, **kw)

    grouped = grid != "per_query"
    if probe_cfg is not None:
        # a measured probe times the dispatch as this batch is served: a
        # grouped grid's schedule from the cache, or, on a miss, built with
        # its pair index, then the kernel. The warm-up call runs on a
        # schedule kept out of the cache, so the timed call misses exactly
        # where the batch would have; each call ends in a synchronize. The
        # sharing probe above is paid by every candidate alike.
        _run(grid, build_schedule(visit, qblk=eff_qblk, pad_block=pad_block)
             if grouped else None)
        _synchronize(visit)
        t0 = time.perf_counter()
        sched = _schedule() if grouped else None
        s, i = _run(grid, sched)
        _synchronize(visit)
        tuner.record(tkey, probe_cfg, sstats["sharing"],
                     time.perf_counter() - t0)
        entry = tuner.lookup(tkey)
        if entry is not None:
            sstats["crossover"] = entry["crossover"]
    else:
        sched = _schedule() if grouped else None
        s, i = _run(grid, sched)
    if grouped:
        sstats["groups"] = sched["groups"]
        sstats["qblk"] = eff_qblk
    sstats["mode"] = grid
    if stats is not None:
        stats.update(sstats)
    return normalize_knockouts(s, i)


def hamming(q_codes, c_codes, *, use_kernel=None):
    """q_codes: (T, Q, W); c_codes: (T, N, W) packed signatures as int32
    bit patterns -> (Q, N) int32 min-over-tables Hamming distance. Ragged
    N needs no padding: the kernel masks its last tile."""
    if kernel_path(c_codes, use_kernel):
        return _hm.hamming_cuda(q_codes, c_codes)
    return _hm.hamming_plain(q_codes, c_codes)


def hamming_shortlist(q_codes, c_codes, L: int, *, use_kernel=None):
    """The LSH engine's ranking pass: the L rows of smallest min-over-tables
    Hamming distance per query, nearest first and equal distances by the
    lower row id -> (dist (Q, L) int32, ids (Q, L) int32). 1 <= L <= N;
    the kernel takes L <= 256."""
    if kernel_path(c_codes, use_kernel):
        return _hm.hamming_shortlist_cuda(q_codes, c_codes, L)
    return _hm.hamming_shortlist_plain(q_codes, c_codes, L)


def flash_attention(q, k, v, *, causal: bool, scale=None, kv_mask=None,
                    window=None, use_kernel=None):
    """q: (B, Sq, H, dh); k/v: (B, Sk, KV, dh); kv_mask: (B, Sk) bool ->
    (B, Sq, H, dh) in q's dtype. GQA reads KV head h // (H // KV); masked
    scores are -1e30, so a fully masked row averages v. The kernel takes
    dh a multiple of 16 up to 256 and no ``window``, and raises otherwise;
    the plain version takes both."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if kernel_path(q, use_kernel):
        return _fa.flash_attention_cuda(q, k, v, causal=causal, scale=scale,
                                        kv_mask=kv_mask, window=window)
    return _fa.flash_attention_plain(q, k, v, causal=causal, scale=scale,
                                     kv_mask=kv_mask, window=window)
