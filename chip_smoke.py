#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--n ROWS] [--seed S] [--rank R] [--min-recall X]

Phases, in order; any failure raises and the script exits non-zero:
  1. header: the card's name, power limit and top SM clock (nvidia-smi),
     torch and CUDA;
  2. build: the five CUDA sources (topk_distance, pq_adc, ivf_adc with its
     three grids, hamming with its matrix and shortlist entries,
     flash_attention), one nvcc each, in parallel; the ptxas lines
     (registers, shared memory, spills);
  3. kernel against plain version at mid size (262,144 rows, d = 768,
     m = 64): ``topk_distance`` with float32 and bf16 corpora for {dot, l2}
     x k in {1, 10, 256} x Q in {1, 5, 16, 32, 33, 128, 512} (every
     query-tile template and a ragged Q) on a ragged N with duplicated rows
     (ties) and a tenth of the rows knocked out; ``pq_adc`` for {dot, l2} x {float32, bfloat16, int8} x
     Q in {1, 32, 512} x k in {10, 200} and a scan_all-shaped case (an
     extra subspace as wide as the cluster count), then at every query
     tile that fits (and the plan's) for each table type x m in {8, 64, 7}
     x Q in {1, 2, 3, 9, 33, 512} x k in {1, 32, 256} on a ragged N with
     duplicated rows and a tenth knocked out, and with the wide extra
     column at every tile; ``ivf_adc``,
     ``ivf_adc_blocked`` and ``ivf_adc_run_resident`` for {dot, l2,
     cosine} x {float32, bfloat16, int8} x Q in {1, 32, 512} (the grouped
     grids at qblk 8, and 4 and 16 for float32 dot), each grouped result
     also against the per-query kernel's, bit for bit; the per-query
     kernel (the plan's variant and the direct-read one, with and without
     the pad block) on synthetic inputs with 0, 30, 60 and 100 % of the
     steps on the pad block for each table type and shared and per-probe
     tables, one real step among 4,095, a query on the pad block alone and
     one with every probe knocked out at k in {1, 256}, m = 7 and m = 210
     float32 at k = 256, against its plain version and both grouped
     kernels (but at m = 210, which no tile fits), bit for bit; the
     grouped grids on synthetic inputs at Q one below, at and one above
     the plan's tile
     width and the widest that fits (at the plan's width and forced to the
     widest: a ragged last tile)
     for each table type, shared and per-probe tables, m in {64, 8, 7}
     (16-byte, word and byte code reads), k in {1, 32, 256}, qblk in
     {4, 8, 16}, and with tiles that have no scheduled pair, a query
     whose every probe is knocked out and an adaptive probe mask, each
     against its plain version and the per-query kernel; ``hamming`` and
     ``hamming_shortlist`` for (T, W) in {(4, 4), (8, 2), (1, 8)} x Q in
     {1, 32, 512} (the shortlist at L in {10, 64, 256}) on words over the
     full 2^32 range, a ragged N and codes of five distinct values (ties
     everywhere), and the shortlist on six distinct codes over 150,011
     rows (ties straddling every threshold) at L in {1, 64, 256} x Q in
     {1, 8, 9, 32, 33, 512}, bit for bit; ``flash_attention`` in bf16 and
     float32 on the reference's FLASH_CASES, the encoder's shapes (B = 32, H = 12,
     dh = 64, S in {64, 128, 512}) with ragged key-padding masks and one
     fully masked row, GQA (H = 8, KV = 2) and dh = 80 at a ragged S = 200,
     causal and not, within the reference's 2e-5 / 2e-2;
  4. main path at full size on the MS MARCO v1 passage count (8,841,823
     rows) of d = 768 cosine embeddings, clustered synthetic data made on
     the card from ``--seed``: ``VectorDB("flat")``, then
     ``VectorDB("flat", dtype=torch.bfloat16)`` (the float32 one dropped;
     its recall@10 against the float32 truth), ``VectorDB("pq")``,
     then ``VectorDB("ivf_pq")`` served under adc_mode auto (the default),
     per_query, blocked and run_resident from one trained state (every
     grid's ids and scores equal per_query's bit for bit), and scan_all at
     Q = 32, the three ivf_adc kernels at Q = 1, 32, 512 beside their
     times before this design, each kernel's device time by the profiler
     (scan and merges) and the visit steps the per-query kernel scored,
     counted by the kernel, against the real ones and Q x T, and on the
     hot set (32 corpus rows x 16 noisy copies, shuffled: its sharing
     factor, all three grids at Q = 32 and 512, the grouped ones bit-equal
     to their plain versions and the per-query kernel, the per-query one
     to its plain version at Q = 32), then ``VectorDB("lsh")`` at the reference
     defaults (128 bits, 4 tables, shortlist 64) with the earlier engines
     dropped, its kernel
     path's ids and scores equal to the plain path's at Q = 1 and 32, and
     its stage times; load seconds, p50/p99 latency and QPS at Q = 1, 32, 512,
     recall@10 against flat, each kernel's time beside its bound, the plain
     version's and a library call's time (``pq_adc`` and
     ``hamming_shortlist`` at Q = 1, 32, 512 with their launch plans and
     their times before this design, at every query tile, by k and by L),
     launches on each engine's path, full-size batches of each kernel
     against its plain version, peak device memory and each phase's
     seconds;
  5. the text path at full width, after the engines of phase 4 are
     dropped: thistle-sbert FULL (12 layers, d_model 768, bf16, seeded
     random weights) encodes 131,072 MarcoLike passages (seq_len 64)
     through ``VectorDB("flat").load_texts`` and serves ``query_texts`` at
     Q = 1, 32, 512; load split (tokenize, encode, index), p50/p99 and QPS,
     stage times, ``flash_attention``'s time beside its bound, its plain
     version's and ``F.scaled_dot_product_attention``'s, one encoder
     block's stage times, one encode at max_seq_len 512, and three gates: the encoder through the kernel
     against the same forward through the plain attention (cosine >=
     0.999 at (32, 64) and (32, 512)), 512 passages sent back as queries
     finding themselves in their top 10 (>= 99 %), and the kernel
     launched on the path;
  6. mutation and serving, after phase 5, on the phase-4 data made again
     from ``--seed``: ``VectorDB("ivf_pq")`` at the reference defaults but
     m = 64 (its copy of the data dropped after load) takes the
     reference's mutation mix (BENCH_mutation.json's paths): 88,418 new
     rows of the same distribution inserted in batches of 1,024, 884,182
     random live ids deleted in batches of 8,192, 88,418 other live ids
     upserted with fresh vectors in batches of 1,024, then ``compact``;
     rows/s of each, compact seconds, the layout's capacity, blocks and
     steps_per_probe and plan_generation before and after, p50/p99 under
     every adc_mode at Q = 1, 32, 512 before the writes, at 10 %
     tombstones and after compact, each ivf_adc kernel's time and the
     visit steps the per-query kernel scored (equal to the real ones);
     checks: no deleted id in any result, every grid equal to per_query
     bit for bit and the kernels to their plain versions on the mutated
     and the compacted layout, 512 inserted and 512 upserted rows found in
     their own top 10 (>= 99 %), results after compact equal to those
     before it (ties aside), the re-rank rows of the written ids equal to
     ``preprocess_corpus`` of the vectors written, the size the writes
     imply, recall@10 against the exact top 10 over the live rows
     (``topk_distance`` on the engine's corpus under the live mask, the
     kernel against its plain version) >= ``--min-recall``; then
     ``QueryEngine`` and ``AsyncQueryEngine`` (max_batch 64) on the
     mutated index: 2,048 single reads with a 64-row insert or delete
     after every 8 (interleaved_1to8; a read behind an insert finds the
     row, no read sees an id deleted before it) and 2,048 reads alone
     (ids equal ``db.query(bucketize=False)``), p50/p99, QPS,
     queue_depth_max, plan hits and misses; then ``flat`` (float32, bf16)
     and ``pq`` at 262,144 rows under the same mix, scaled: each kernel
     path against its plain path on the mutated buffers and the float32
     flat against brute force over the live rows; peak device memory;
  7. a JSON line of the kernels, then the result line.

It needs one CUDA card and the repository's ``src/`` beside it, and it
imports nothing of the JAX package.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

MARCO_PASSAGES = 8_841_823   # MS MARCO v1 passage collection
DIM = 768                    # SBERT embedding width (configs/thistle_sbert.py)
M_SUBSPACES = 64             # 12 dimensions a subspace
MID_ROWS = 262_144
BATCHES = (1, 32, 512)
REPS = {1: 30, 32: 12, 512: 4}
GROUPED = ("blocked", "run_resident")
HBM_BYTES_PER_S = 3.35e12    # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
TF32_OPS_PER_S = 495e12      # H100 SXM dense TF32 on the tensor cores
BF16_OPS_PER_S = 989e12      # H100 SXM dense bf16 on the tensor cores
TOPK_QS = (1, 5, 16, 32, 33, 128, 512)  # every query-tile template, a ragged Q
TOPK_KS = (1, 10, 256)
# 32-bit population counts a clock per SM at compute capability 9.0 (CUDA
# C++ Programming Guide, arithmetic instruction throughput table); times the
# SM count and the top SM clock nvidia-smi reports, it bounds hamming (three
# popcounts for each four-word table of a (query, row) pair, main_lsh)
POPC_PER_CLOCK_PER_SM = 16
# 32-bit shared-memory words served a clock per SM (32 banks): an ADC table
# term is one lookup; times the SM count and the top SM clock, it bounds
# pq_adc and the ivf_adc grids together with their adds, which run at half
# FP32_OPS_PER_S (an add is one operation, an FMA two)
LOOKUPS_PER_CLOCK_PER_SM = 32
# The redesigned kernels' times before this design (PERF.md section 6:
# chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W; pq_adc float32 table,
# k = 32; hamming_shortlist L = 64; the ivf_adc grids float32 tables,
# k = 32, the grouped ones at qblk = 8), printed beside this run's
EARLIER_MS = {"pq_adc": {1: 1.675, 32: 42.960, 512: 757.685},
              "hamming_shortlist": {1: 0.715, 32: 8.822, 512: 46.098},
              "ivf_adc": {1: 0.127, 32: 0.286, 512: 2.043},
              "ivf_adc_blocked": {1: 0.254, 32: 0.747, 512: 4.357},
              "ivf_adc_run_resident": {1: 0.277, 32: 0.774, 512: 4.515}}
PQ_TILE_MS = (8, 64, 7)        # phase 3's pq_adc sweep: m = 7 is byte-staged
PQ_TILE_QS = (1, 2, 3, 9, 33, 512)
PQ_TILE_KS = (1, 32, 256)
GROUPED_TILE_MS = (64, 8, 7)   # phase 3's grouped sweep: 16-byte, word, byte reads
GROUPED_QBLKS = (4, 8, 16)
PAD_SHARES = (0.0, 0.3, 0.6, 1.0)  # phase 3's per-query sweep: pad steps
HOT_ROWS, HOT_COPIES = 32, 16  # phase 4's hot set (hot_queries)
TIE_ROWS = 150_011             # phase 3's hamming tie case
HAMMING_SHAPES = ((4, 4), (8, 2), (1, 8))   # (tables, words): 128, 16, 256 bits
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}   # the reference's (tests/test_kernels.py)
FLASH_MID_CASES = (
    # (B, Sq, Sk, H, KV, dh, causal, masked)
    # the reference's FLASH_CASES, (BH, S, dh) as B = BH, H = 1
    (2, 128, 128, 1, 1, 64, True, False),
    (1, 256, 256, 1, 1, 128, True, False),
    (3, 128, 128, 1, 1, 32, False, False),
    (2, 192, 192, 1, 1, 64, True, False),
    (1, 64, 64, 1, 1, 80, False, False),
    # the encoder's shapes, ragged lengths and one empty row
    (32, 64, 64, 12, 12, 64, False, True),
    (32, 128, 128, 12, 12, 64, False, True),
    (32, 512, 512, 12, 12, 64, False, True),
    # GQA
    (4, 256, 256, 8, 2, 64, False, True),
    (4, 256, 256, 8, 2, 64, True, True),
    # dh = 80 at a ragged S
    (4, 200, 200, 4, 4, 80, False, True),
    (4, 200, 200, 4, 4, 80, True, True),
)
TEXT_PASSAGES = 131_072      # MarcoLike passages of the text phase
TEXT_SEQ = 64                # tokens a text
TEXT_BATCH = 512             # load_texts batch
TEXT_FLASH_SHAPES = ((512, 64), (32, 64), (1, 64), (32, 512))  # (B, S) encoded


def log(*args) -> None:
    print(*args, flush=True)


# ----------------------------------------------------------------- data
def cluster_frame(d: int, gen, device, *, n_centres: int, rank: int):
    """(centres, basis): ``n_centres`` random unit centres and a
    ``rank``-dimensional subspace they share, the first draws of ``gen``."""
    import torch
    centres = torch.randn(n_centres, d, generator=gen, device=device)
    centres /= torch.linalg.vector_norm(centres, dim=1, keepdim=True)
    basis = torch.randn(rank, d, generator=gen, device=device) / math.sqrt(d)
    return centres, basis


def clustered_rows(n: int, d: int, gen, device, *, n_centres: int,
                   rank: int = 8, spread: float = 0.35, noise: float = 0.01,
                   chunk: int = 1 << 18, frame=None):
    """Unit rows around ``n_centres`` random unit centres: each row is its
    centre plus a draw from a ``rank``-dimensional subspace shared by all
    centres (scale ``spread``) plus isotropic noise, normalized. Made on
    ``device`` from ``gen``, a chunk of rows at a time; ``frame`` (from
    ``cluster_frame``) gives the centres and subspace, else ``gen`` draws
    them first."""
    import torch
    centres, basis = frame or cluster_frame(d, gen, device,
                                            n_centres=n_centres, rank=rank)
    out = torch.empty((n, d), dtype=torch.float32, device=device)
    for a in range(0, n, chunk):
        b = min(n, a + chunk)
        which = torch.randint(centres.shape[0], (b - a,), generator=gen,
                              device=device)
        z = torch.randn(b - a, rank, generator=gen, device=device) * spread
        x = centres[which] + z @ basis
        x += noise * torch.randn(b - a, d, generator=gen, device=device)
        out[a:b] = x / torch.linalg.vector_norm(x, dim=1, keepdim=True)
    return out


def make_dataset(n: int, n_queries: int, seed: int, device, rank: int = 8):
    """(corpus (n, d), queries (n_queries, d)): floor(sqrt(n)) centres, as
    many as the coarse lists ivf_pq trains by default; queries are noisy
    copies of held-out rows of the same distribution. ``rank`` 0 leaves
    out the shared subspace: unit centres plus isotropic noise."""
    import torch
    gen = torch.Generator(device=device).manual_seed(seed)
    rows = clustered_rows(n + n_queries, DIM, gen, device,
                          n_centres=max(1, math.isqrt(n)), rank=rank)
    corpus = rows[:n]
    held = rows[n:].clone()
    del rows
    q = held + 0.01 * torch.randn(held.shape, generator=gen, device=device)
    return corpus, q / torch.linalg.vector_norm(q, dim=1, keepdim=True)


def new_rows(n_new: int, n: int, seed: int, salt: int, device, rank: int = 8):
    """``n_new`` more rows of ``make_dataset(n, ..., seed)``'s distribution:
    the same centres and shared subspace (re-drawn from ``seed``), the rows
    themselves from a generator of their own (``seed + salt``)."""
    import torch
    frame = cluster_frame(DIM, torch.Generator(device=device).manual_seed(seed),
                          device, n_centres=max(1, math.isqrt(n)), rank=rank)
    gen = torch.Generator(device=device).manual_seed(seed + salt)
    return clustered_rows(n_new, DIM, gen, device, n_centres=len(frame[0]),
                          rank=rank, frame=frame)


# ------------------------------------------------------------ measuring
def gpu_ms(fn, reps: int) -> float:
    """Mean device milliseconds of fn() over reps, after one warm-up call,
    between CUDA events."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def device_us(fn, reps: int = 5) -> dict:
    """Device microseconds a call of fn() spends in each kernel, by
    torch.profiler's CUDA activity over reps calls after a warm-up:
    {kernel name (its template name, cut at '('): us a call}."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        # a kernel's own device time; a host op's kernels are its children
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0 and not e.key.startswith(("aten::", "Activity")):
            name = e.key.replace("void ", "").replace(
                "(anonymous namespace)::", "").replace("at::native::", "")
            name = name.split("(")[0].split("<")[0]
            out[name] = out.get(name, 0.0) + us / reps
    return out


def bound_ms(n_bytes: float, n_ops: float,
             ops_per_s: float = FP32_OPS_PER_S) -> tuple:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def adc_bound(n_bytes: float, terms: float, lookups_per_s: float) -> tuple:
    """Least time of an ADC scan: its bytes over the memory rate against
    its table terms, each one shared-memory lookup (``lookups_per_s``) and
    one float32 add (half of FP32_OPS_PER_S); the largest binds."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(terms / lookups_per_s, terms / (FP32_OPS_PER_S / 2)) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def percentile(xs, p: float) -> float:
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(math.ceil(p / 100 * len(xs))) - 1)]


def serve_batches(db, queries, label: str) -> dict:
    """Run the query batches through the front, one batch of Q queries
    served again and again (so ivf_pq's schedule cache hits after the
    first); host clock around work that ends in a synchronize. Returns
    {Q: (scores, ids)} of the last rep."""
    import torch
    last = {}
    for Q in BATCHES:
        q = queries[:Q]
        db.query(q, k=10)  # warm-up
        torch.cuda.synchronize()
        times = []
        for _ in range(REPS[Q]):
            t0 = time.perf_counter()
            s, i = db.query(q, k=10)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        last[Q] = (s, i)
        p50, p99 = percentile(times, 50), percentile(times, 99)
        log(f"  {label} Q={Q}: p50 {p50 * 1e3:.3f} ms, p99 {p99 * 1e3:.3f} ms "
            f"(n={len(times)}, one batch repeated), QPS "
            f"{Q * len(times) / sum(times):.1f}")
        if not (torch.isfinite(s[:, 0]).all() and s.shape == (Q, 10)):
            raise AssertionError(f"{label} Q={Q}: bad result {tuple(s.shape)}")
    return last


# --------------------------------------------------------- comparisons
def topk_tolerance(corpus, q, l2: bool):
    """Bound on |kernel - plain| for one score: both sum d products in
    float32 in different orders, each within d * 2^-24 * |q| * |c| of the
    exact dot (x2 for l2), plus a few roundings of the score itself. A bf16
    corpus adds the float32 rounding of its products (2^-24 |q| |c|, x2 for
    l2): the norms are those of the stored bf16 values."""
    import torch
    c_max = float(torch.linalg.vector_norm(corpus.float(), dim=1).max())
    q_norm = torch.linalg.vector_norm(q.float(), dim=1)
    d = corpus.shape[1]
    terms = 2 * d + (1 if corpus.dtype == torch.bfloat16 else 0)
    return (2.0 if l2 else 1.0) * terms * 2.0 ** -24 * q_norm * c_max


def compare_topk(corpus, q, metric: str, k: int, label: str,
                 valid=None) -> float:
    """ops.topk_distance on the kernel and on the plain version (the same
    corpus dtype, float32 or bf16). Scores agree rank by rank within the
    tolerance; an id may differ only where the kernel's row scores,
    exactly in float64, within twice the tolerance of the plain version's
    score at that rank (a near-tie); every id is a live row."""
    import torch
    from repro_torch.kernels import ops
    sq = (torch.sum(corpus.float() * corpus.float(), dim=1)
          if metric == "l2" else None)
    kw = dict(k=k, metric=metric, corpus_sq=sq, valid=valid)
    ks, ki = ops.topk_distance(corpus, q, use_kernel=True, **kw)
    ps, pi = ops.topk_distance(corpus, q, use_kernel=False, **kw)
    torch.cuda.synchronize()
    tol = topk_tolerance(corpus, q, metric == "l2")[:, None]
    err = (ks - ps).abs()
    if not bool((err <= tol).all()):
        raise AssertionError(f"{label}: score error {float(err.max())} above "
                             f"bound {float(tol.max())}")
    if valid is not None and not bool(valid[ki.long()].all()):
        raise AssertionError(f"{label}: a knocked-out row in the top k")
    same = ki == pi.to(ki.dtype)
    if not bool(same.all()):
        rows, cols = torch.nonzero(~same, as_tuple=True)
        c64 = corpus[ki[rows, cols].long()].double()
        q64 = q[rows].double()
        exact = (c64 * q64).sum(1)
        if metric == "l2":
            exact = -((q64 - c64) ** 2).sum(1)
        gap = (exact - ps[rows, cols].double()).abs()
        if not bool((gap <= 2 * tol[rows, 0].double() + 1e-12).all()):
            raise AssertionError(f"{label}: ids differ beyond near-ties")
    log(f"  {label}: ids agree {float(same.float().mean()):.4f} (bound: all but "
        f"near-ties), max |dscore| {float(err.max()):.3e} (bound "
        f"{float(tol.max()):.3e})")
    return float(err.max())


def topk_bound(N: int, d: int, Q: int, k: int, bf16: bool) -> tuple:
    """Least time for one topk_distance call: the corpus, the row bias and
    q read once, the (Q, k) result written once, against 2 Q N d products:
    bf16 on the tensor cores (989 TFLOP/s); float32 at the lesser of
    3xTF32 on the tensor cores (3 x 2 Q N d at 495 TFLOP/s, the cheapest
    float32-accurate route, the kernel's) and float32 FMAs (67 TFLOP/s)."""
    esize = 2 if bf16 else 4
    n_bytes = N * d * esize + N * 4 + Q * d * esize + Q * k * 8
    ops = 2.0 * Q * N * d
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = (ops / BF16_OPS_PER_S if bf16 else
             min(3 * ops / TF32_OPS_PER_S, ops / FP32_OPS_PER_S)) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def same_result(a, b) -> bool:
    """Bit equality of two (scores, ids) results, -inf matching -inf."""
    import torch
    (ks, ki), (ps, pi) = a, b
    same_s = (ks == ps) | (torch.isneginf(ks) & torch.isneginf(ps))
    return bool(same_s.all()) and bool((ki == pi.to(ki.dtype)).all())


def bit_equal(kern, plain, label: str) -> float:
    """Check a kernel's result against its plain version's: the same
    float32 operations in the same order, so the bound is bit equality.
    Returns the largest |dscore| over finite entries (0 when equal)."""
    import torch
    torch.cuda.synchronize()
    (ks, ki), (ps, pi) = kern, plain
    finite = torch.isfinite(ks) & torch.isfinite(ps)
    err = float((ks - ps)[finite].abs().max()) if bool(finite.any()) else 0.0
    agree = float((ki == pi.to(ki.dtype)).float().mean())
    log(f"  {label}: ids agree {agree:.4f} (bound 1), max |dscore| "
        f"{err:.3e} (bound 0, bit equality)")
    if not same_result(kern, plain):
        raise AssertionError(f"{label}: kernel and plain version differ")
    return err


def compare_ivf(bucket_codes, bucket_ids, visit, luts, coarse, *, k, spp,
                lut_dtype, label) -> float:
    """ops.ivf_adc_topk's per-query grid on the kernel and on the plain
    version, the last block the all-pad one, as the engine passes it."""
    from repro_torch.kernels import ops
    args = (bucket_codes, bucket_ids, visit, luts)
    kw = dict(k=k, coarse=coarse, steps_per_probe=spp, lut_dtype=lut_dtype,
              mode="per_query", pad_block=bucket_ids.shape[0] - 1)
    return bit_equal(ops.ivf_adc_topk(*args, use_kernel=True, **kw),
                     ops.ivf_adc_topk(*args, use_kernel=False, **kw), label)


def compare_grouped(bucket_codes, bucket_ids, visit, luts, coarse, *, k, spp,
                    lut_dtype, mode, qblk, label) -> float:
    """A grouped grid on the kernel against its plain version, and against
    the per-query kernel: all three bit for bit."""
    from repro_torch.kernels import ops
    args = (bucket_codes, bucket_ids, visit, luts)
    kw = dict(k=k, coarse=coarse, steps_per_probe=spp, lut_dtype=lut_dtype,
              pad_block=bucket_ids.shape[0] - 1)
    kern = ops.ivf_adc_topk(*args, use_kernel=True, mode=mode, qblk=qblk,
                            **kw)
    err = bit_equal(kern, ops.ivf_adc_topk(*args, use_kernel=False, mode=mode,
                                           qblk=qblk, **kw), label)
    if not same_result(kern, ops.ivf_adc_topk(*args, use_kernel=True,
                                              mode="per_query", **kw)):
        raise AssertionError(f"{label}: differs from the per-query kernel")
    return err


def compare_pq(codes, luts, *, k, lut_dtype, label, valid=None,
               extra=None) -> float:
    """ops.adc_topk (the pq_adc kernel) against its plain version."""
    from repro_torch.kernels import ops
    kw = dict(k=k, valid=valid, extra_codes=extra, lut_dtype=lut_dtype)
    return bit_equal(ops.adc_topk(codes, luts, use_kernel=True, **kw),
                     ops.adc_topk(codes, luts, use_kernel=False, **kw), label)


def probe_inputs(index, q):
    """The ivf_adc kernels' inputs for queries q, as the engine builds them:
    (bucket codes, bucket ids, visit, luts, coarse, steps_per_probe)."""
    from repro_torch.core import distances as D
    from repro_torch.core.pq import _ivf_probe_stage
    index._sync()
    metric = index.metric
    q = q.float()
    if metric == "cosine":
        q, metric = D.l2_normalize(q), "dot"
    visit, luts, coarse, _ = _ivf_probe_stage(
        index.codebooks, index.centroids, q, index.block_table, metric=metric,
        nprobe=index.nprobe, steps_per_probe=index.spp,
        pad_block=index.bucket_ids.shape[0] - 1)
    return index.codes_bm, index.bucket_ids, visit, luts, coarse, index.spp


def pq_inputs(index, q):
    """pq_adc's inputs for queries q on a PQ engine: (codes, luts, valid)."""
    from repro_torch.core import distances as D
    from repro_torch.core.pq import adc_tables
    index._sync()
    metric = index.metric
    q = q.float()
    if metric == "cosine":
        q, metric = D.l2_normalize(q), "dot"
    return index.codes, adc_tables(index.codebooks, q, metric=metric), \
        index.valid


def scan_all_inputs(index, q):
    """pq_adc's inputs on IVF-PQ's all-codes path (cosine or dot index):
    (row-major codes, (Q, m + 1, W) tables, cluster ids, live mask)."""
    from repro_torch.core import distances as D
    from repro_torch.core.pq import scan_all_tables
    index._sync()
    q = q.float()
    if index.metric == "cosine":
        q = D.l2_normalize(q)
    n = index.n
    return (index.layout.gather_payload(n),
            scan_all_tables(index.codebooks, index.centroids, q),
            index.layout.assign_of(n), index.layout.live_mask(n))


# -------------------------------------------------------------- phases
def nvidia_smi(query: str) -> str:
    """First card's line of ``nvidia-smi --query-gpu=<query>``."""
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0]


def phase_header() -> tuple:
    """Log the card; returns (name and power limit, rates a second: the
    popcounts', POPC_PER_CLOCK_PER_SM x SMs x top SM clock, and the
    shared-memory lookups', LOOKUPS_PER_CLOCK_PER_SM x SMs x top clock)."""
    import torch
    smi = nvidia_smi("name,power.limit")
    log(smi)
    mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rates = {"popc": POPC_PER_CLOCK_PER_SM * sms * mhz * 1e6,
             "lookups": LOOKUPS_PER_CLOCK_PER_SM * sms * mhz * 1e6}
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, "
        f"count {torch.cuda.device_count()}, SMs {sms}, top SM clock "
        f"{mhz:.0f} MHz, popcount rate {rates['popc']:.4e}/s, shared-memory "
        f"lookup rate {rates['lookups']:.4e}/s")
    return smi, rates


def phase_build() -> None:
    from repro_torch.kernels import _build
    secs = _build.build_all(["topk_distance", "pq_adc", "ivf_adc", "hamming",
                             "flash_attention"])
    for name, s in secs.items():
        log(f"build {name}: {s:.1f} s")
        for line in _build.build_log(name).splitlines():
            if any(w in line for w in ("Compiling entry", "registers",
                                       "spill", "bytes stack")):
                log(f"  {line.strip()}")


def phase_mid(seed: int, device, rank: int) -> None:
    import torch
    from repro_torch import VectorDB
    log(f"phase 3: kernel against plain version, N={MID_ROWS}, d={DIM}, "
        f"m={M_SUBSPACES}")
    corpus, queries = make_dataset(MID_ROWS, 512, seed + 1, device, rank)
    topk_mid(corpus, queries, seed)
    for metric in ("dot", "l2"):
        db = VectorDB("pq", metric=metric, m=M_SUBSPACES,
                      device=device).load(corpus)
        for Q in BATCHES:
            codes, luts, valid = pq_inputs(db.index, queries[:Q])
            for lut_dtype in ("float32", "bfloat16", "int8"):
                for k in (10, 200):
                    compare_pq(codes, luts, k=k, lut_dtype=lut_dtype,
                               valid=valid,
                               label=f"pq_adc {metric} {lut_dtype} k={k} Q={Q}")
        del db
    for metric in ("dot", "l2", "cosine"):
        db = VectorDB("ivf_pq", metric=metric, m=M_SUBSPACES,
                      device=device).load(corpus)
        for Q in BATCHES:
            args = probe_inputs(db.index, queries[:Q])
            kw = dict(k=32, spp=args[5])
            for lut_dtype in ("float32", "bfloat16", "int8"):
                compare_ivf(*args[:5], lut_dtype=lut_dtype, **kw,
                            label=f"ivf_adc {metric} {lut_dtype} Q={Q}")
                for mode in GROUPED:
                    compare_grouped(*args[:5], lut_dtype=lut_dtype, mode=mode,
                                    qblk=8, **kw,
                                    label=f"ivf_adc_{mode} {metric} "
                                          f"{lut_dtype} qblk=8 Q={Q}")
            if metric == "dot":
                for qblk in (4, 16):
                    for mode in GROUPED:
                        compare_grouped(*args[:5], lut_dtype="float32",
                                        mode=mode, qblk=qblk, **kw,
                                        label=f"ivf_adc_{mode} dot float32 "
                                              f"qblk={qblk} Q={Q}")
        if metric == "cosine":
            codes, luts, assign, live = scan_all_inputs(db.index, queries[:32])
            compare_pq(codes, luts, k=32, lut_dtype="float32", valid=live,
                       extra=assign,
                       label=f"pq_adc scan_all float32 W={luts.shape[2]} "
                             f"(ksub {db.index.codebooks.shape[1]}) Q=32")
        del db
    del corpus, queries
    torch.cuda.empty_cache()
    pq_tiles_mid(seed, device)
    per_query_mid(seed, device)
    grouped_tiles_mid(seed, device)
    hamming_mid(seed, device)
    flash_mid(seed, device)


def topk_mid(corpus, queries, seed: int) -> None:
    """topk_distance against its plain version on a ragged corpus (MID_ROWS
    - 77 rows plus 64 duplicated rows, whose scores tie and go to the lower
    id) with a tenth of the rows knocked out, in float32 and bf16, at every
    Q of TOPK_QS (each query-tile template and a ragged Q) and k of
    TOPK_KS, for the dot and l2 metrics; each plan is printed once."""
    import torch
    from repro_torch.kernels.topk_distance import plan
    gen = torch.Generator(device=corpus.device).manual_seed(seed + 5)
    c32 = torch.cat([corpus[:MID_ROWS - 77], corpus[:64]])
    valid = torch.rand(c32.shape[0], generator=gen,
                       device=corpus.device) >= 0.1
    for dtype in (torch.float32, torch.bfloat16):
        c, qs = c32.to(dtype), queries.to(dtype)
        name = str(dtype).split(".")[-1]
        for Q in TOPK_QS:
            for k in TOPK_KS:
                p = plan(c.shape[0], Q, DIM, k, dtype)
                log(f"  topk_distance {name} plan Q={Q} k={k}: {p}")
                for metric in ("dot", "l2"):
                    compare_topk(c, qs[:Q], metric, k,
                                 f"topk_distance {name} {metric} k={k} Q={Q} "
                                 f"N={c.shape[0]}", valid=valid)
        del c, qs
    torch.cuda.empty_cache()


def pq_tiles_mid(seed: int, device) -> None:
    """pq_adc against its plain version, bit for bit, at every query tile
    up to Q that fits and at the plan's, for each table type, m in PQ_TILE_MS, Q in
    PQ_TILE_QS and k in PQ_TILE_KS, on a ragged N with duplicated rows and
    a tenth knocked out; then scan_all's wide extra column (W = 2973) at
    every query tile that fits, Q = 33."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.pq_adc import (QTS, fit_qt, plan, pq_adc_cuda,
                                            pq_adc_plain)
    gen = torch.Generator(device=device).manual_seed(seed + 6)
    card = _build.card(device)
    N = MID_ROWS - 77
    bias = torch.where(torch.rand(N, generator=gen, device=device) >= 0.1,
                       0.0, -1e30).float()
    for m in PQ_TILE_MS:
        codes = torch.randint(0, 256, (N, m), generator=gen, device=device,
                              dtype=torch.uint8)
        codes[-300:] = codes[:300]
        for Q in PQ_TILE_QS:
            luts = torch.randn(Q, m, 256, generator=gen, device=device)
            for lut_dtype in ("float32", "bfloat16", "int8"):
                for k in PQ_TILE_KS:
                    want = pq_adc_plain(codes, luts, bias, k=k,
                                        lut_dtype=lut_dtype)
                    top = fit_qt(m, 256, k, lut_dtype, 0, card)
                    p = plan(N, Q, m, 256, k, lut_dtype, 0, card)
                    tiles = {t for t in QTS if t <= min(top, Q)}
                    for qt in sorted(tiles | {p["qt"]}):
                        mark = " (plan)" if qt == p["qt"] else ""
                        bit_equal(pq_adc_cuda(codes, luts, bias, k=k,
                                              lut_dtype=lut_dtype, qt=qt),
                                  want, f"pq_adc {lut_dtype} m={m} Q={Q} "
                                        f"k={k} N={N} query tile {qt}{mark}")
        del codes
    m, W, Q = M_SUBSPACES, 2973, 33
    codes = torch.randint(0, 256, (N, m), generator=gen, device=device,
                          dtype=torch.uint8)
    extra = torch.randint(0, W, (N,), generator=gen, device=device,
                          dtype=torch.int32)
    luts = torch.randn(Q, m + 1, W, generator=gen, device=device)
    for lut_dtype in ("float32", "bfloat16", "int8"):
        want = pq_adc_plain(codes, luts, bias, k=32, extra=extra,
                            lut_dtype=lut_dtype)
        top = fit_qt(m, W, 32, lut_dtype, 1, card)
        for qt in [t for t in QTS if t <= top]:
            bit_equal(pq_adc_cuda(codes, luts, bias, k=32, extra=extra,
                                  lut_dtype=lut_dtype, qt=qt), want,
                      f"pq_adc {lut_dtype} extra W={W} Q={Q} k=32 query "
                      f"tile {qt}")
    del codes, extra, luts
    torch.cuda.empty_cache()


def grouped_inputs(gen, device, *, Q, m, per_probe, B=4000, blk=32,
                   nprobe=8, spp=32, ksub=256, pad_share=0.3):
    """Synthetic grouped-grid inputs made on the card: random codes with a
    tenth of the slots -1, a (Q, nprobe * spp) visit table over B - 1
    blocks with a share of visits to the pad block (B - 1, all -1), random
    tables (per (query, probe) with ``per_probe``) and coarse terms."""
    import torch
    codes = torch.randint(0, ksub, (B, blk, m), generator=gen, device=device,
                          dtype=torch.uint8)
    ids = torch.arange(B * blk, device=device,
                       dtype=torch.int32).reshape(B, blk)
    ids[torch.rand((B, blk), generator=gen, device=device) < 0.1] = -1
    ids[-1] = -1
    T = nprobe * spp
    visit = torch.randint(0, B - 1, (Q, T), generator=gen, device=device,
                          dtype=torch.int32)
    visit[torch.rand((Q, T), generator=gen, device=device) < pad_share] = B - 1
    shape = (Q, nprobe, m, ksub) if per_probe else (Q, m, ksub)
    luts = torch.randn(shape, generator=gen, device=device)
    coarse = torch.randn((Q, nprobe), generator=gen, device=device)
    return codes, ids, visit, luts, coarse, spp


def grouped_case(codes, ids, visit, luts, coarse, spp, *, k, lut_dtype, qblk,
                 tiles, label) -> int:
    """Both grouped kernels, at the plan's tile width and at each of
    ``tiles``, against their plain versions and the per-query kernel, bit
    for bit; raises on the first difference. Returns the cases checked."""
    from repro_torch.kernels import ivf_adc as K
    from repro_torch.kernels import ops
    kw = dict(k=k, steps_per_probe=spp, lut_dtype=lut_dtype)
    per_query = ops.normalize_knockouts(*K.ivf_adc_cuda(
        codes, ids, visit, luts, coarse, pad_block=ids.shape[0] - 1, **kw))
    sched = ops.build_schedule(visit, qblk=qblk, pad_block=ids.shape[0] - 1)
    n = 0
    for runs, plain, name in (
            (False, K.ivf_adc_blocked_plain, "blocked"),
            (True, K.ivf_adc_run_resident_plain, "run_resident")):
        want = ops.normalize_knockouts(*plain(codes, ids, visit, sched, luts,
                                              coarse, **kw))
        if not same_result(want, per_query):
            raise AssertionError(f"{label} {name}: plain version differs "
                                 "from the per-query kernel")
        for qt in (None,) + tuple(tiles):
            got = ops.normalize_knockouts(*K._grouped_cuda(
                codes, ids, visit, sched, luts, coarse, runs=runs, qt=qt,
                **kw))
            if not same_result(got, want):
                raise AssertionError(f"ivf_adc_{name} {label} qt={qt}: "
                                     "kernel and plain version differ")
            n += 1
    return n


def per_query_case(codes, ids, visit, luts, coarse, spp, *, k, lut_dtype,
                   label, grouped=True) -> int:
    """The per-query kernel (the plan's variant, and the direct-read one
    forced, each with the pad block and with none given) against its plain
    version and, where a tile fits, both grouped kernels at qblk 8, bit for
    bit; raises on the first difference. Returns the results checked."""
    from repro_torch.kernels import ivf_adc as K
    from repro_torch.kernels import ops
    kw = dict(k=k, steps_per_probe=spp, lut_dtype=lut_dtype)
    pad = ids.shape[0] - 1
    want = ops.normalize_knockouts(*K.ivf_adc_plain(codes, ids, visit, luts,
                                                    coarse, **kw))
    n = 0
    for ring in (None, False):
        for pad_block in (pad, None):
            got = ops.normalize_knockouts(*K._per_query_cuda(
                codes, ids, visit, luts, coarse, ring=ring,
                pad_block=pad_block, **kw))
            if not same_result(got, want):
                raise AssertionError(f"ivf_adc {label} ring={ring} pad_block="
                                     f"{pad_block}: kernel and plain version "
                                     "differ")
            n += 1
    if grouped:
        sched = ops.build_schedule(visit, qblk=8, pad_block=pad)
        for name, fn in (("blocked", K.ivf_adc_blocked_cuda),
                         ("run_resident", K.ivf_adc_run_resident_cuda)):
            got = ops.normalize_knockouts(*fn(codes, ids, visit, sched, luts,
                                              coarse, **kw))
            if not same_result(got, want):
                raise AssertionError(f"ivf_adc_{name} {label}: differs from "
                                     "the per-query grid")
            n += 1
    return n


def per_query_mid(seed: int, device) -> None:
    """The per-query kernel on synthetic inputs (4,000 blocks of 32 slots),
    bit for bit against its plain version and both grouped kernels: a share
    of the steps on the pad block in PAD_SHARES, for each table type,
    shared and per-probe tables; then one real step among 4,095 pad steps,
    a query that visits only the pad block and one whose every probe is
    knocked out, k = 1 and 256, m = 7 (byte reads) and m = 210 float32 at
    k = 256 (the direct-read variant; no grouped tile fits it)."""
    import torch
    gen = torch.Generator(device=device).manual_seed(seed + 9)
    t0 = time.perf_counter()
    total = 0
    for pad_share in PAD_SHARES:
        for lut_dtype in ("float32", "bfloat16", "int8"):
            for per_probe in (False, True):
                *args, spp = grouped_inputs(gen, device, Q=40, m=M_SUBSPACES,
                                            per_probe=per_probe,
                                            pad_share=pad_share)
                args[4][3, 2] = -1e30  # a knocked-out probe
                total += per_query_case(
                    *args, spp, k=32, lut_dtype=lut_dtype,
                    label=f"pad share {pad_share} {lut_dtype} "
                          f"per_probe={per_probe}")
    log(f"  ivf_adc per-query kernel at pad shares {PAD_SHARES}, each table "
        "type, shared and per-probe tables: equal to its plain version and "
        "both grouped kernels bit for bit")
    for per_probe in (False, True):
        *args, spp = grouped_inputs(gen, device, Q=1, m=M_SUBSPACES, spp=512,
                                    per_probe=per_probe)
        codes, ids, visit = args[:3]
        visit[:] = ids.shape[0] - 1
        visit[0, 3 * 512 + 5] = 17    # one real step among 4,095
        for k in (1, 32):
            total += per_query_case(*args, spp, k=k, lut_dtype="float32",
                                    label=f"one real step per_probe="
                                          f"{per_probe} k={k}")
        *args, spp = grouped_inputs(gen, device, Q=12, m=M_SUBSPACES,
                                    per_probe=per_probe)
        args[2][4] = args[1].shape[0] - 1   # a query on the pad block alone
        args[4][7] = -1e30                  # every probe knocked out
        for lut_dtype in ("float32", "bfloat16", "int8"):
            for k in (1, 256):
                total += per_query_case(
                    *args, spp, k=k, lut_dtype=lut_dtype,
                    label=f"all-pad and knocked-out queries {lut_dtype} "
                          f"per_probe={per_probe} k={k}")
        for lut_dtype in ("float32", "bfloat16", "int8"):
            *args, spp = grouped_inputs(gen, device, Q=9, m=7,
                                        per_probe=per_probe)
            total += per_query_case(*args, spp, k=32, lut_dtype=lut_dtype,
                                    label=f"m=7 {lut_dtype} "
                                          f"per_probe={per_probe}")
        *args, spp = grouped_inputs(gen, device, Q=5, m=210,
                                    per_probe=per_probe)
        total += per_query_case(*args, spp, k=256, lut_dtype="float32",
                                label=f"m=210 float32 k=256 "
                                      f"per_probe={per_probe}",
                                grouped=False)
    log(f"  ivf_adc per-query kernel: one real step among 4,095, all-pad and "
        f"knocked-out queries, k in (1, 256), m = 7 and m = 210 float32 at "
        f"k = 256 (direct reads) equal too; {total} results in "
        f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()


def grouped_tiles_mid(seed: int, device) -> None:
    """The grouped kernels on synthetic inputs (4,000 blocks of 32 slots,
    nprobe 8 x 32 steps), bit for bit against their plain versions and the
    per-query kernel: Q one below, at and one above the plan's tile width
    and the widest that fits, at the plan's width and forced to the widest
    (a ragged last tile), for each table type, shared and per-probe
    tables, m in GROUPED_TILE_MS, k in (1, 32, 256), qblk in
    GROUPED_QBLKS; then tiles with no scheduled pair, a query whose every
    probe is knocked out, an adaptive probe mask, and blocks of 8 x 7 and
    6 x 8 code bytes (staged byte by byte)."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.ivf_adc import fit_tile, plan_width
    gen = torch.Generator(device=device).manual_seed(seed + 7)
    card = _build.card(device)
    t0 = time.perf_counter()
    total = 0
    for m in GROUPED_TILE_MS:
        for lut_dtype in ("float32", "bfloat16", "int8"):
            for per_probe in (False, True):
                n = 0
                cw = 1 if per_probe else 8  # coarse terms a table row
                for k in PQ_TILE_KS:
                    top = fit_tile(m, 256, 32, k, lut_dtype, card, cw)
                    width = plan_width(m, 256, 32, k, lut_dtype, card, cw)
                    for Q in sorted({max(1, w + d) for w in (width, top)
                                     for d in (-1, 0, 1)}):
                        *args, spp = grouped_inputs(gen, device, Q=Q, m=m,
                                                    per_probe=per_probe)
                        args[4][0, 1] = -1e30  # a knocked-out probe
                        for qblk in GROUPED_QBLKS:
                            n += grouped_case(
                                *args, spp, k=k, lut_dtype=lut_dtype,
                                qblk=qblk, tiles=(top,),
                                label=f"{lut_dtype} m={m} per_probe="
                                      f"{per_probe} k={k} Q={Q} qblk={qblk}")
                log(f"  ivf_adc grouped kernels {lut_dtype} m={m} "
                    f"{'per-probe' if per_probe else 'shared'} tables: {n} "
                    f"cases (Q one below, at and one above the plan's and "
                    f"the widest tile at k in {PQ_TILE_KS}, qblk in "
                    f"{GROUPED_QBLKS}) equal their plain versions and the "
                    f"per-query kernel bit for bit")
                total += n
    for lut_dtype in ("float32", "bfloat16", "int8"):
        for per_probe in (False, True):
            codes, ids, visit, luts, coarse, spp = grouped_inputs(
                gen, device, Q=40, m=M_SUBSPACES, per_probe=per_probe)
            pad = ids.shape[0] - 1
            visit[:12] = pad                  # the first tiles: no pair
            coarse[20] = -1e30                # every probe knocked out
            drop = torch.rand((40, 8), generator=gen, device=device) < 0.5
            drop[:, 0] = False                # adaptive: probe 0 stays
            visit[torch.repeat_interleave(drop, spp, dim=1)] = pad
            coarse[drop] = -1e30
            for qblk in GROUPED_QBLKS:
                total += grouped_case(
                    codes, ids, visit, luts, coarse, spp, k=32,
                    lut_dtype=lut_dtype, qblk=qblk, tiles=(1,),
                    label=f"{lut_dtype} per_probe={per_probe} empty tiles, "
                          f"knocked-out query, adaptive mask qblk={qblk}")
    for blk, m in ((8, 7), (6, 8)):  # blocks staged byte by byte
        for lut_dtype in ("float32", "bfloat16", "int8"):
            for per_probe in (False, True):
                *args, spp = grouped_inputs(gen, device, Q=10, m=m, blk=blk,
                                            per_probe=per_probe)
                total += grouped_case(
                    *args, spp, k=32, lut_dtype=lut_dtype, qblk=8,
                    tiles=(1,), label=f"{lut_dtype} blk={blk} m={m} "
                                      f"per_probe={per_probe}")
    log(f"  ivf_adc grouped kernels: empty tiles, a query with every probe "
        f"knocked out, an adaptive probe mask and blocks staged byte by "
        f"byte (blk, m in (8, 7), (6, 8)) equal too; {total} cases in "
        f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()


def random_words(gen, shape, device):
    """int32 bit patterns over the full 2^32 range."""
    import torch
    return torch.randint(-2 ** 31, 2 ** 31, shape, generator=gen,
                         device=device, dtype=torch.int64).to(torch.int32)


def compare_hamming(qc, cc, L: int, label: str, full: bool) -> float:
    """hamming_shortlist (and with ``full`` the matrix entry) on the kernel
    against the plain version: integer results, so bit equality. Returns
    the largest |ddist| (0 when equal)."""
    import torch
    from repro_torch.kernels import ops
    kern = ops.hamming_shortlist(qc, cc, L, use_kernel=True)
    plain = ops.hamming_shortlist(qc, cc, L, use_kernel=False)
    err = bit_equal((kern[0].float(), kern[1]), (plain[0].float(), plain[1]),
                    f"hamming_shortlist {label} L={L}")
    if full:
        same = torch.equal(ops.hamming(qc, cc, use_kernel=True),
                           ops.hamming(qc, cc, use_kernel=False))
        log(f"  hamming {label}: (Q, N) matrix equal {same} (bound: equal)")
        if not same:
            raise AssertionError(f"hamming {label}: kernel and plain differ")
    return err


def hamming_mid(seed: int, device) -> None:
    """Both hamming entries against their plain versions at MID_ROWS rows:
    random words at each (T, W) and Q, a ragged N, and heavy ties."""
    import torch
    gen = torch.Generator(device=device).manual_seed(seed + 2)
    for T, W in HAMMING_SHAPES:
        cc = random_words(gen, (T, MID_ROWS, W), device)
        for Q in BATCHES:
            qc = random_words(gen, (T, Q, W), device)
            for L in (10, 64, 256):
                compare_hamming(qc, cc, L, f"T={T} W={W} Q={Q}",
                                full=L == 10)
        del cc
    cc = random_words(gen, (4, MID_ROWS - 77, 4), device)
    compare_hamming(random_words(gen, (4, 32, 4), device), cc, 64,
                    f"T=4 W=4 Q=32 N={MID_ROWS - 77} (ragged)", full=True)
    distinct = random_words(gen, (4, 5, 4), device)
    pick = torch.randint(0, 5, (MID_ROWS,), generator=gen, device=device)
    cc = distinct[:, pick].contiguous()
    qc = torch.cat([distinct, random_words(gen, (4, 27, 4), device)], dim=1)
    for L in (64, 256):
        compare_hamming(qc, cc, L, "T=4 W=4 Q=32, five distinct codes (ties)",
                        full=L == 64)
    # six distinct codes over TIE_ROWS rows: ties straddle every query's
    # threshold across tiles and chunks
    distinct = random_words(gen, (4, 6, 4), device)
    pick = torch.randint(0, 6, (TIE_ROWS,), generator=gen, device=device)
    cc = distinct[:, pick].contiguous()
    for Q in (1, 8, 9, 32, 33, 512):
        qc = torch.cat([distinct, random_words(gen, (4, Q, 4), device)],
                       dim=1)[:, :Q].contiguous()
        for L in (1, 64, 256):
            compare_hamming(qc, cc, L, f"T=4 W=4 Q={Q} N={TIE_ROWS}, six "
                                       f"distinct codes (ties)", full=False)
    del cc, qc
    torch.cuda.empty_cache()


def ragged_mask(gen, B: int, S: int, device, empty_row: bool = True):
    """(B, S) key-padding mask of lengths drawn from 1..S; the first row is
    full and, with ``empty_row``, the last one fully masked."""
    import torch
    lengths = torch.randint(1, S + 1, (B,), generator=gen, device=device)
    lengths[0] = S
    if empty_row and B > 1:
        lengths[-1] = 0
    return torch.arange(S, device=device)[None, :] < lengths[:, None]


def compare_flash(q, k, v, mask, causal: bool, label: str) -> float:
    """flash_attention's kernel against its plain version: |kernel - plain|
    <= tol + tol * |plain| elementwise at the reference's tolerance for the
    dtype. Returns the largest |difference|."""
    import torch
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_attention_plain)
    kw = dict(causal=causal, scale=q.shape[-1] ** -0.5, kv_mask=mask)
    got = flash_attention_cuda(q, k, v, **kw).float()
    want = flash_attention_plain(q, k, v, **kw).float()
    torch.cuda.synchronize()
    tol = FLASH_TOL[str(q.dtype).split(".")[-1]]
    err = (got - want).abs()
    ok = bool((err <= tol + tol * want.abs()).all()) and bool(
        torch.isfinite(got).all())
    log(f"  {label}: max |do| {float(err.max()):.3e} (bound {tol} + {tol} "
        f"|o|)")
    if not ok:
        raise AssertionError(f"{label}: kernel and plain version differ")
    return float(err.max())


def flash_mid(seed: int, device) -> None:
    """flash_attention against its plain version on FLASH_MID_CASES, in
    bf16 and float32."""
    import torch
    gen = torch.Generator(device=device).manual_seed(seed + 3)
    for B, Sq, Sk, H, KV, dh, causal, masked in FLASH_MID_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            q = torch.randn(B, Sq, H, dh, generator=gen, device=device).to(dtype)
            k = torch.randn(B, Sk, KV, dh, generator=gen, device=device).to(dtype)
            v = torch.randn(B, Sk, KV, dh, generator=gen, device=device).to(dtype)
            mask = ragged_mask(gen, B, Sk, device) if masked else None
            compare_flash(q, k, v, mask, causal,
                          f"flash_attention {str(dtype)[6:]} B={B} Sq={Sq} "
                          f"Sk={Sk} H={H} KV={KV} dh={dh} causal={causal} "
                          f"mask={'ragged+empty' if masked else 'none'}")
    torch.cuda.empty_cache()


def serve_and_count(db, queries, label: str):
    """Serve the batches with every launch count set to 0 just before;
    returns (last results per Q, launch counts just after)."""
    from repro_torch.kernels import ops
    ops.reset_launch_counts()
    res = serve_batches(db, queries, label)
    counts = ops.launch_counts()
    log(f"  launches on the {label} path: {counts}")
    return res, counts


def recall_at_10(got, truth) -> float:
    return float(sum(len(set(got[r].tolist()) & set(truth[r].tolist()))
                     for r in range(got.shape[0])) / (10 * got.shape[0]))


def kernel_entry(name, source, replaces, launches, err, ms, plain_ms, bound,
                 library_ms, shape) -> dict:
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0],
            "bound_by": bound[1], "library_ms": library_ms, "shape": shape}


def phase_main(n: int, seed: int, device, rank: int, min_recall: float,
               rates: dict) -> tuple:
    import torch
    log(f"phase 4: main path, N={n} rows (MS MARCO v1 passages: "
        f"{MARCO_PASSAGES}), d={DIM}, cosine, shared subspace rank {rank}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    corpus, queries = make_dataset(n, max(BATCHES), seed, device, rank)
    torch.cuda.synchronize()
    log(f"  data made on the card: {time.perf_counter() - t0:.2f} s")
    kernels, launches, recalls = [], {}, {}
    t0 = time.perf_counter()
    truth = main_flat(corpus, queries, device, kernels, launches)
    log(f"  [flat: {time.perf_counter() - t0:.1f} s]")
    t0 = time.perf_counter()
    recalls["pq"] = main_pq(corpus, queries, truth, device, kernels, launches,
                            rates["lookups"])
    log(f"  [pq: {time.perf_counter() - t0:.1f} s]")
    t0 = time.perf_counter()
    recalls["ivf_pq"] = main_ivf(corpus, queries, truth, device, kernels,
                                 launches, rates["lookups"], seed)
    log(f"  [ivf_pq: {time.perf_counter() - t0:.1f} s]")
    peak = torch.cuda.max_memory_allocated()
    log(f"  peak device memory through ivf_pq: {peak / 1e9:.2f} GB")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    recalls["lsh"] = main_lsh(corpus, queries, truth, device, kernels,
                              launches, rates["popc"])
    log(f"  [lsh: {time.perf_counter() - t0:.1f} s]")
    lsh_peak = torch.cuda.max_memory_allocated()
    log(f"  peak device memory in lsh (earlier engines dropped): "
        f"{lsh_peak / 1e9:.2f} GB; whole phase "
        f"{max(peak, lsh_peak) / 1e9:.2f} GB")
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"{name} never launched on the main path")
    for engine in ("ivf_pq", "lsh"):
        if recalls[engine] < min_recall:
            raise AssertionError(f"{engine} recall@10 {recalls[engine]:.4f} "
                                 f"below {min_recall}")
    return kernels, recalls


def library_topk(corpus, q, k: int, chunk: int = 128):
    """torch.matmul + torch.topk over the corpus (the yardstick, used
    nowhere in the port), queries in chunks of ``chunk`` rows so that the
    (Q, N) score matrix stays within memory (Q = 512 at N = 8,841,823 is
    18 GB in float32)."""
    import torch
    for a in range(0, q.shape[0], chunk):
        torch.topk(q[a:a + chunk] @ corpus.T, k)


def time_topk(corpus, queries, label: str) -> dict:
    """The kernel, its plain version and torch.matmul + torch.topk at each
    Q of BATCHES on the engine's corpus (k = 10, dot), beside the bound;
    at Q <= 32 also the kernel with the query tile's other placement
    (resident in shared memory or riding in the ring), which the launch
    plan did not pick. Returns {Q: (ms, plain_ms, library_ms, bound)}."""
    import torch
    from repro_torch.kernels.topk_distance import (plan, topk_distance_cuda,
                                                   topk_distance_plain)
    N = corpus.shape[0]
    bf16 = corpus.dtype == torch.bfloat16
    bias = torch.zeros(N, dtype=torch.float32, device=corpus.device)
    out = {}
    for Q in BATCHES:
        q = queries[:Q].to(corpus.dtype)
        ms = gpu_ms(lambda: topk_distance_cuda(corpus, q, bias, k=10,
                                               l2=False), 5)
        plain_ms = gpu_ms(lambda: topk_distance_plain(corpus, q, bias, k=10,
                                                      l2=False), 1)
        lib_ms = gpu_ms(lambda: library_topk(corpus, q, 10), 2)
        b = topk_bound(N, DIM, Q, 10, bf16)
        out[Q] = (ms, plain_ms, lib_ms, b)
        p = plan(N, Q, DIM, 10, corpus.dtype)
        log(f"  topk_distance {label} Q={Q}: kernel {ms:.3f} ms, plain "
            f"{plain_ms:.3f} ms, torch.matmul+torch.topk {lib_ms:.3f} ms"
            f"{' (4 chunks of 128 queries)' if Q > 128 else ''}, bound "
            f"{b[0]:.3f} ms ({b[1]}); plan {p}")
        if Q <= 32:
            other = 1 - p["resident"]
            o_ms = gpu_ms(lambda: topk_distance_cuda(corpus, q, bias, k=10,
                                                     l2=False,
                                                     resident=other), 5)
            log(f"    the other placement (resident={other}, plan "
                f"{plan(N, Q, DIM, 10, corpus.dtype, other)}): {o_ms:.3f} ms")
    return out


def by_q(times) -> dict:
    """time_topk's numbers keyed by batch size, for the kernels line."""
    return {str(Q): {"ms": t[0], "plain_ms": t[1], "library_ms": t[2],
                     "bound_ms": t[3][0], "bound_by": t[3][1]}
            for Q, t in times.items()}


def main_flat(corpus, queries, device, kernels, launches):
    """flat, the exact ground truth: serve, time topk_distance; then the
    same engine with a bf16 corpus (the f32 one dropped first): serve,
    recall against the f32 truth, time. Returns the f32 truth."""
    import torch
    from repro_torch import VectorDB
    from repro_torch.kernels import ops
    t0 = time.perf_counter()
    flat = VectorDB("flat", metric="cosine", device=device).load(corpus)
    torch.cuda.synchronize()
    log(f"  flat load: {time.perf_counter() - t0:.2f} s")
    res, counts = serve_and_count(flat, queries, "flat")
    launches["topk_distance"] = counts["topk_distance"]
    truth = res[max(BATCHES)][1]
    fc = flat.index.corpus
    times = time_topk(fc, queries, "float32")
    ms, lib_ms = times[32][0], times[32][2]
    log(f"  topk_distance float32 Q=32: kernel {ms:.3f} ms against "
        f"torch.matmul+torch.topk {lib_ms:.3f} ms: "
        f"{'below' if ms < lib_ms else 'NOT below'} the library call")
    err = max(compare_topk(fc, queries[:Q], "dot", 10,
                           f"topk_distance float32 full size Q={Q}")
              for Q in BATCHES)
    entry = kernel_entry(
        "topk_distance", "src/repro_torch/csrc/topk_distance.cu",
        "src/repro/kernels/topk_distance.py:77", launches["topk_distance"],
        err, *times[32][:2], times[32][3], lib_ms,
        f"Q=32 N={fc.shape[0]} d={DIM} k=10 float32 corpus (3xTF32); by_q: "
        f"Q = 1, 32, 512; bf16: the same kernel on the bf16 flat corpus; "
        f"library_ms: torch.matmul + torch.topk (Q = 512 in 4 chunks of "
        f"128 queries)")
    entry["by_q"] = by_q(times)
    del flat, fc, res
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    flat = VectorDB("flat", metric="cosine", dtype=torch.bfloat16,
                    device=device).load(corpus)
    torch.cuda.synchronize()
    fc = flat.index.corpus
    log(f"  flat bf16 load: {time.perf_counter() - t0:.2f} s (corpus "
        f"{fc.dtype}, {fc.numel() * fc.element_size() / 1e9:.2f} GB on the "
        f"card)")
    res, counts = serve_and_count(flat, queries, "flat bf16")
    if counts["topk_distance"] <= 0:
        raise AssertionError("topk_distance never launched on the bf16 flat "
                             "path")
    recall = recall_at_10(res[max(BATCHES)][1], truth)
    log(f"  recall@10 of flat bf16 against flat float32: {recall:.4f} "
        f"({truth.shape[0]} queries; printed, not gated)")
    times = time_topk(fc, queries, "bfloat16")
    err16 = max(compare_topk(fc, queries[:Q].to(torch.bfloat16), "dot", 10,
                             f"topk_distance bfloat16 full size Q={Q}")
                for Q in BATCHES)
    ms, plain_ms, lib_ms, b = times[32]
    entry["bf16"] = {"launches": counts["topk_distance"], "max_abs_err": err16,
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": b[0],
                     "bound_by": b[1], "library_ms": lib_ms,
                     "by_q": by_q(times), "recall_at_10_vs_float32": recall}
    kernels.append(entry)
    log(f"  peak device memory through flat: "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del flat, fc, res
    ops.reset_launch_counts()
    torch.cuda.empty_cache()
    return truth


def pq_bound(codes, luts, valid, k: int, lookups_per_s: float) -> tuple:
    """Least time for one pq_adc call on these inputs: the codes, the row
    bias and the tables read once, the (Q, k) result written once, against
    m table terms for each (query, live row) pair, each a shared-memory
    lookup and a float32 add (``adc_bound``)."""
    N, m = codes.shape
    Q = luts.shape[0]
    live = int(valid.sum())
    return adc_bound(N * m + N * 4 + luts.numel() * 4 + Q * k * 8,
                     float(Q) * live * m, lookups_per_s)


def main_pq(corpus, queries, truth, device, kernels, launches,
            lookups_per_s: float) -> float:
    """pq, the flat PQ engine: serve, recall, time pq_adc."""
    import torch
    from repro_torch import VectorDB
    from repro_torch.kernels import ops
    from repro_torch.kernels import _build
    from repro_torch.kernels.pq_adc import (QTS, fit_qt, plan, pq_adc_cuda,
                                            pq_adc_plain)
    t0 = time.perf_counter()
    db = VectorDB("pq", metric="cosine", m=M_SUBSPACES,
                  device=device).load(corpus)
    torch.cuda.synchronize()
    log(f"  pq load: {time.perf_counter() - t0:.2f} s (codes "
        f"{db.index.memory_bytes() / 1e9:.3f} GB with the live mask and "
        f"codebooks)")
    res, counts = serve_and_count(db, queries, "pq")
    launches["pq_adc"] = counts["pq_adc"]
    recall = recall_at_10(res[max(BATCHES)][1], truth)
    log(f"  recall@10 of pq against flat: {recall:.4f} "
        f"({truth.shape[0]} queries)")
    k = db.index.refine
    by_q = {}
    for Q in BATCHES:
        codes, luts, valid = pq_inputs(db.index, queries[:Q])
        bias = torch.where(valid, 0.0, -1e30).float()
        ms = gpu_ms(lambda: pq_adc_cuda(codes, luts, bias, k=k), 3)
        b = pq_bound(codes, luts, valid, k, lookups_per_s)
        by_q[str(Q)] = {"ms": ms, "bound_ms": b[0], "bound_by": b[1]}
        p = plan(codes.shape[0], Q, codes.shape[1], luts.shape[2], k,
                 "float32", 0, _build.card(codes.device))
        log(f"  pq_adc kernel Q={Q}: {ms:.3f} ms (bound {b[0]:.3f} ms, "
            f"{b[1]}; before this design {EARLIER_MS['pq_adc'][Q]:.3f} ms); "
            f"plan {p}")
    codes, luts, valid = pq_inputs(db.index, queries[:1])
    bias = torch.where(valid, 0.0, -1e30).float()
    by_k = {kk: gpu_ms(lambda: pq_adc_cuda(codes, luts, bias, k=kk), 5)
            for kk in (1, k)}
    log(f"  pq_adc Q=1 by k: k=1 {by_k[1]:.3f} ms, k={k} {by_k[k]:.3f} ms "
        f"(the same lookups; the boards' work grows with k)")
    codes, luts, valid = pq_inputs(db.index, queries[:32])
    bias = torch.where(valid, 0.0, -1e30).float()
    ms = by_q["32"]["ms"]
    plain_ms = gpu_ms(lambda: pq_adc_plain(codes, luts, bias, k=k), 1)
    bound = pq_bound(codes, luts, valid, k, lookups_per_s)
    for qt in QTS:
        if qt <= fit_qt(codes.shape[1], luts.shape[2], k, "float32", 0,
                        _build.card(codes.device)):
            t = gpu_ms(lambda: pq_adc_cuda(codes, luts, bias, k=k, qt=qt), 3)
            log(f"    pq_adc Q=32 at query tile {qt}: {t:.3f} ms")
    err = 0.0
    for Q in BATCHES:
        c, lt, v = pq_inputs(db.index, queries[:Q])
        err = max(err, compare_pq(c, lt, k=k, lut_dtype="float32", valid=v,
                                  label=f"pq_adc full size Q={Q}"))
    entry = kernel_entry(
        "pq_adc", "src/repro_torch/csrc/pq_adc.cu",
        "src/repro/kernels/pq_adc.py:122", launches["pq_adc"], err, ms,
        plain_ms, bound, None,
        f"Q=32 N={codes.shape[0]} m={codes.shape[1]} k={k}; library_ms "
        f"null: no single PyTorch call gathers and sums table entries")
    entry["by_q"] = by_q
    kernels.append(entry)
    log(f"  pq_adc Q=32: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
        f"{bound[0]:.3f} ms ({bound[1]}), no single library call")
    del db, codes, luts, valid, bias, res
    ops.reset_launch_counts()
    torch.cuda.empty_cache()
    return recall


def hot_queries(corpus, seed: int, device):
    """The hot set: HOT_ROWS corpus rows, each repeated HOT_COPIES times
    with noise of 0.01 a dimension, normalized, in an order shuffled by
    seed. Popular queries recur across users (Xie and O'Hallaron, "Locality
    in Search Engine Queries and Its Implications for Caching", INFOCOM
    2002: query popularity is Zipf-like); the 32 x 16 split stands in for
    the head of that distribution and is not taken from the study."""
    import torch
    gen = torch.Generator(device=device).manual_seed(seed + 8)
    rows = torch.randperm(corpus.shape[0], generator=gen,
                          device=device)[:HOT_ROWS]
    q = corpus[rows].repeat_interleave(HOT_COPIES, dim=0)
    q = q + 0.01 * torch.randn(q.shape, generator=gen, device=device)
    q = q / torch.linalg.vector_norm(q, dim=1, keepdim=True)
    return q[torch.randperm(q.shape[0], generator=gen, device=device)]


def main_ivf(corpus, queries, truth, device, kernels, launches,
             lookups_per_s: float, seed: int) -> float:
    """ivf_pq, trained once, served under every grid; scan_all at Q = 32;
    the three ivf_adc kernels timed on the phase's queries and on the hot
    set."""
    import torch
    from repro_torch import VectorDB
    from repro_torch.kernels import ivf_adc as K
    from repro_torch.kernels import ops
    from repro_torch.kernels.autotune import LEDGER
    t0 = time.perf_counter()
    db = VectorDB("ivf_pq", metric="cosine", m=M_SUBSPACES,
                  device=device).load(corpus)
    torch.cuda.synchronize()
    idx = db.index
    log(f"  ivf_pq load: {time.perf_counter() - t0:.2f} s "
        f"(clusters {idx.centroids.shape[0]}, steps_per_probe "
        f"{idx.spp}, storage rows {idx.layout.capacity}, layout "
        f"{idx.layout.memory_bytes() / 1e9:.3f} GB, adc_mode {idx.adc_mode})")
    ops.reset_launch_counts()
    results = {}
    for mode in ("auto", "per_query") + GROUPED:
        idx.adc_mode = mode
        results[mode] = serve_batches(db, queries, f"ivf_pq {mode}")
    counts = ops.launch_counts()
    log(f"  launches on the ivf_pq path (all four modes): {counts}")
    for name in ("ivf_adc",) + tuple(f"ivf_adc_{m}" for m in GROUPED):
        launches[name] = counts[name]
    for mode in ("auto",) + GROUPED:
        for Q in BATCHES:
            if not same_result(results[mode][Q], results["per_query"][Q]):
                raise AssertionError(f"ivf_pq {mode} Q={Q} differs from "
                                     "per_query")
    log("  ivf_pq auto, blocked and run_resident equal per_query bit for bit "
        f"at Q = {BATCHES}")
    log(f"  adc_stats: {db.adc_stats}")
    log(f"  autotuner decisions: {LEDGER.decisions()}")
    recall = recall_at_10(results["per_query"][max(BATCHES)][1], truth)
    log(f"  recall@10 of ivf_pq against flat: {recall:.4f} "
        f"({truth.shape[0]} queries)")
    idx.adc_mode = "per_query"
    ivf_breakdown(idx, queries)

    k, blk, m = idx.refine, idx.block_size, idx.codebooks.shape[0]
    grids = {"ivf_adc": (K.ivf_adc_cuda, K.ivf_adc_plain, None),
             "ivf_adc_blocked": (K.ivf_adc_blocked_cuda,
                                 K.ivf_adc_blocked_plain, "blocked"),
             "ivf_adc_run_resident": (K.ivf_adc_run_resident_cuda,
                                      K.ivf_adc_run_resident_plain,
                                      "run_resident")}
    timed, by_q = {}, {name: {} for name in grids}
    for Q in BATCHES:
        codes, ids, visit, luts, coarse, spp = probe_inputs(idx, queries[:Q])
        t_s = time.perf_counter()
        sched = ops.build_schedule(visit, qblk=8, pad_block=ids.shape[0] - 1)
        torch.cuda.synchronize()
        t_s = (time.perf_counter() - t_s) * 1e3
        t_v = time.perf_counter()
        share = ops.visit_sharing(visit, pad_block=ids.shape[0] - 1)
        t_v = (time.perf_counter() - t_v) * 1e3
        log(f"  Q={Q}: visit_sharing {t_v:.3f} ms (host clock, one "
            f"torch.unique and a sync; {share}), build_schedule qblk=8 "
            f"{t_s:.3f} ms (host clock, device sort and one sync; groups "
            f"{sched['groups']}, runs {sched['n_runs']})")
        for name, (cuda, plain, mode) in grids.items():
            if mode is None:
                def fn():
                    return cuda(codes, ids, visit, luts, coarse, k=k,
                                steps_per_probe=spp,
                                pad_block=ids.shape[0] - 1)
            else:
                def fn():
                    return cuda(codes, ids, visit, sched, luts, coarse, k=k,
                                steps_per_probe=spp)
            ms = gpu_ms(fn, 5)
            b = ivf_bound(ids, visit, luts, coarse, blk, m, lookups_per_s, k,
                          sched if mode else None)
            by_q[name][Q] = (ms, b)
            before = (f"; before this design {EARLIER_MS[name][Q]:.3f} ms"
                      if name in EARLIER_MS else "")
            dev_us = device_us(fn)
            log(f"  {name} kernel Q={Q}: {ms:.3f} ms (bound {b[0]:.3f} ms, "
                f"{b[1]}{before}); device us a call by kernel (profiler): "
                + ", ".join(f"{n} {u:.1f}" for n, u in dev_us.items()))
            if mode is None:
                walked_steps(codes, ids, visit, luts, coarse, spp, k, Q)
            if Q == 32:
                args = ((codes, ids, visit, luts, coarse) if mode is None
                        else (codes, ids, visit, sched, luts, coarse))
                plain_ms = gpu_ms(lambda: plain(*args, k=k,
                                                steps_per_probe=spp), 2)
                timed[name] = (ms, plain_ms, b, f"Q=32 T={visit.shape[1]} "
                               f"blk={blk} m={m} k={k}"
                               + (f" qblk=8 groups={sched['groups']}"
                                  if mode else ""))
    errs = dict.fromkeys(grids, 0.0)
    for Q in BATCHES:
        args = probe_inputs(idx, queries[:Q])
        kw = dict(k=k, spp=args[5], lut_dtype="float32")
        if Q < max(BATCHES):
            errs["ivf_adc"] = max(errs["ivf_adc"], compare_ivf(
                *args[:5], **kw, label=f"ivf_adc full size Q={Q}"))
        for mode in GROUPED:
            errs[f"ivf_adc_{mode}"] = max(errs[f"ivf_adc_{mode}"],
                                          compare_grouped(
                *args[:5], mode=mode, qblk=8, **kw,
                label=f"ivf_adc_{mode} full size Q={Q}"))
    hot_set(idx, corpus, seed, device, grids, lookups_per_s)
    for name, (ms, plain_ms, b, shape) in timed.items():
        kernels.append(kernel_entry(
            name, "src/repro_torch/csrc/ivf_adc.cu",
            {"ivf_adc": "src/repro/kernels/ivf_adc.py:150",
             "ivf_adc_blocked": "src/repro/kernels/ivf_adc.py:284",
             "ivf_adc_run_resident": "src/repro/kernels/ivf_adc.py:469"}[name],
            launches[name], errs[name], ms, plain_ms, b, None,
            shape + "; library_ms null: no single PyTorch call gathers and "
            "sums table entries"))
        kernels[-1]["by_q"] = {str(Q): {"ms": t[0], "bound_ms": t[1][0],
                                        "bound_by": t[1][1]}
                               for Q, t in by_q[name].items()}
        log(f"  {name} Q=32: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
            f"bound {b[0]:.3f} ms ({b[1]}), no single library call")

    # scan_all from the same trained state (the corpus tensor is shared)
    t0 = time.perf_counter()
    sdb = VectorDB("ivf_pq", metric="cosine", m=M_SUBSPACES, scan_all=True,
                   device=device).load_state(idx.state_dict())
    torch.cuda.synchronize()
    log(f"  ivf_pq scan_all load_state: {time.perf_counter() - t0:.2f} s")
    q32 = queries[:32]
    sdb.query(q32, k=10)
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS[32]):
        t0 = time.perf_counter()
        s, i = sdb.query(q32, k=10)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    s_recall = recall_at_10(i, truth[:32])
    log(f"  ivf_pq scan_all Q=32: p50 {percentile(times, 50) * 1e3:.3f} ms, "
        f"p99 {percentile(times, 99) * 1e3:.3f} ms (n={len(times)}), "
        f"recall@10 against flat {s_recall:.4f}")
    codes, luts, assign, live = scan_all_inputs(idx, q32)
    compare_pq(codes, luts, k=k, lut_dtype="float32", valid=live,
               extra=assign, label=f"pq_adc scan_all full size W="
                                   f"{luts.shape[2]} Q=32")
    del sdb, db, idx, codes, luts, assign, live
    torch.cuda.empty_cache()
    return recall


def hot_set(idx, corpus, seed: int, device, grids: dict,
            lookups_per_s: float) -> None:
    """The three ivf_adc kernels on the hot set at Q = 32 and 512: the
    sharing factor, each grid's time beside the bound, and both grouped
    grids against their plain versions and the per-query kernel, bit for
    bit."""
    import torch
    from repro_torch.kernels import ops
    hot = hot_queries(corpus, seed, device)
    k, blk, m = idx.refine, idx.block_size, idx.codebooks.shape[0]
    for Q in (32, 512):
        codes, ids, visit, luts, coarse, spp = probe_inputs(idx, hot[:Q])
        pad = ids.shape[0] - 1
        share = ops.visit_sharing(visit, pad_block=pad)
        sched = ops.build_schedule(visit, qblk=8, pad_block=pad)
        times = {}
        for name, (cuda, _, mode) in grids.items():
            if mode is None:
                times[name] = gpu_ms(lambda: cuda(codes, ids, visit, luts,
                                                  coarse, k=k,
                                                  steps_per_probe=spp,
                                                  pad_block=pad), 5)
            else:
                times[name] = gpu_ms(lambda: cuda(codes, ids, visit, sched,
                                                  luts, coarse, k=k,
                                                  steps_per_probe=spp), 5)
        b = ivf_bound(ids, visit, luts, coarse, blk, m, lookups_per_s, k)
        log(f"  hot set Q={Q} ({HOT_ROWS} rows x {HOT_COPIES} noisy copies, "
            f"shuffled): sharing {share['sharing']:.3f} (pairs "
            f"{share['pairs']}, blocks {share['blocks']}; groups "
            f"{sched['groups']}, runs {sched['n_runs']}); "
            + ", ".join(f"{n} {t:.3f} ms" for n, t in times.items())
            + f" (bound {b[0]:.3f} ms, {b[1]})")
        if Q < max(BATCHES):
            compare_ivf(codes, ids, visit, luts, coarse, k=k, spp=spp,
                        lut_dtype="float32", label=f"ivf_adc hot set Q={Q}")
        for mode in GROUPED:
            compare_grouped(codes, ids, visit, luts, coarse, k=k, spp=spp,
                            lut_dtype="float32", mode=mode, qblk=8,
                            label=f"ivf_adc_{mode} hot set Q={Q}")
    del hot
    torch.cuda.empty_cache()


def ivf_breakdown(idx, queries) -> None:
    """Device ms of each ivf_pq query stage at each batch size (CUDA
    events, stage by stage): probe stage (centroid scores, top-nprobe,
    visit table, tables), the ivf_adc scan, the exact re-rank."""
    from repro_torch.core import distances as D
    from repro_torch.core.pq import _exact_rerank, _ivf_probe_stage
    from repro_torch.kernels import ops
    for Q in BATCHES:
        q = D.l2_normalize(queries[:Q].float())
        args = (idx.codebooks, idx.centroids, q, idx.block_table)
        kw = dict(metric="dot", nprobe=idx.nprobe, steps_per_probe=idx.spp,
                  pad_block=idx.bucket_ids.shape[0] - 1)
        probe = gpu_ms(lambda: _ivf_probe_stage(*args, **kw), 5)
        visit, luts, coarse, _ = _ivf_probe_stage(*args, **kw)
        scan = gpu_ms(lambda: ops.ivf_adc_topk(
            idx.codes_bm, idx.bucket_ids, visit, luts, k=idx.refine,
            coarse=coarse, steps_per_probe=idx.spp, mode="per_query",
            pad_block=kw["pad_block"]), 5)
        _, cand = ops.ivf_adc_topk(idx.codes_bm, idx.bucket_ids, visit, luts,
                                   k=idx.refine, coarse=coarse,
                                   steps_per_probe=idx.spp, mode="per_query",
                                   pad_block=kw["pad_block"])
        rerank = gpu_ms(lambda: _exact_rerank(idx.corpus, idx.corpus_sq, cand,
                                              q, metric="dot", k=10), 5)
        log(f"  ivf_pq stages Q={Q}: probe stage {probe:.3f} ms, ivf_adc "
            f"{scan:.3f} ms, re-rank {rerank:.3f} ms (device ms, CUDA events)")


def main_lsh(corpus, queries, truth, device, kernels, launches,
             popc_per_s: float) -> float:
    """lsh at the reference defaults: serve, recall, kernel path against
    the plain path, stage times, the hamming kernels timed."""
    import torch
    from repro_torch import VectorDB
    from repro_torch.core import distances as D
    from repro_torch.core.lsh import lsh_search, sign_codes
    from repro_torch.kernels import ops
    from repro_torch.kernels import _build
    from repro_torch.kernels.hamming import (hamming_cuda,
                                             hamming_shortlist_cuda,
                                             hamming_shortlist_plain,
                                             shortlist_plan)
    t0 = time.perf_counter()
    db = VectorDB("lsh", metric="cosine", device=device).load(corpus)
    torch.cuda.synchronize()
    idx = db.index
    T, N, W = idx.codes.shape
    L = min(idx.shortlist, N)
    log(f"  lsh load: {time.perf_counter() - t0:.2f} s (n_bits "
        f"{idx.n_bits}, tables {idx.n_tables}, shortlist {idx.shortlist}; "
        f"codes and planes {idx.memory_bytes() / 1e9:.3f} GB)")
    res, counts = serve_and_count(db, queries, "lsh")
    launches["hamming"] = counts["hamming"]
    recall = recall_at_10(res[max(BATCHES)][1], truth)
    log(f"  recall@10 of lsh against flat: {recall:.4f} "
        f"({truth.shape[0]} queries)")
    for Q in (1, 32):
        q = queries[:Q]
        plain = lsh_search(idx.corpus, idx.codes, idx.planes, q,
                           metric="cosine", k=10, shortlist=idx.shortlist,
                           use_kernel=False)
        if not same_result(db.query(q, k=10), plain):
            raise AssertionError(f"lsh Q={Q}: kernel path differs from the "
                                 "plain path")
    log("  lsh kernel path equals the plain path (ids and scores, bit for "
        "bit) at Q = 1 and 32")
    lsh_breakdown(idx, queries)

    def q_codes(Q):
        return sign_codes(D.l2_normalize(queries[:Q].float()), idx.planes)

    # popcounts a (query, row) pair needs at fewest: a four-word table
    # takes three (one carry-save step counts three of its words with two),
    # any other width one a word
    popc_per_pair = T * (3 if W == 4 else W)

    def bound(Q, out_bytes):
        return bound_ms(idx.codes.numel() * 4 + T * Q * W * 4 + out_bytes,
                        float(Q) * N * popc_per_pair, popc_per_s)

    timed = {}
    for Q in BATCHES:
        qc = q_codes(Q)
        ms = gpu_ms(lambda: hamming_shortlist_cuda(qc, idx.codes, L), 5)
        b = bound(Q, Q * L * 8)
        timed[Q] = (ms, b)
        p = shortlist_plan(N, Q, T, W, L, _build.card(qc.device))
        log(f"  hamming_shortlist kernel Q={Q} L={L}: {ms:.3f} ms (bound "
            f"{b[0]:.3f} ms, {b[1]}; before this design "
            f"{EARLIER_MS['hamming_shortlist'][Q]:.3f} ms); plan {p}")
    for Q in (1, 32):
        qc = q_codes(Q)
        ms = gpu_ms(lambda: hamming_cuda(qc, idx.codes), 3)
        b = bound(Q, Q * N * 4)
        log(f"  hamming (Q, N) matrix kernel Q={Q}: {ms:.3f} ms (bound "
            f"{b[0]:.3f} ms, {b[1]})")
    for Q in (32, 512):
        qc = q_codes(Q)
        caps = {cap: gpu_ms(lambda: hamming_shortlist_cuda(qc, idx.codes, L,
                                                           cap), 3)
                for cap in (8, 16, 32)}
        log(f"  hamming_shortlist Q={Q} L={L} by query tile cap: " + ", ".join(
            f"{cap}: {ms:.3f} ms" for cap, ms in caps.items()))
    for Q in (1, 32):
        qc = q_codes(Q)
        by_l = {n: gpu_ms(lambda: hamming_shortlist_cuda(qc, idx.codes, n), 3)
                for n in (1, 256)}
        log(f"  hamming_shortlist kernel Q={Q} by shortlist length: L=1 "
            f"{by_l[1]:.3f} ms, L={L} {timed[Q][0]:.3f} ms, L=256 "
            f"{by_l[256]:.3f} ms (the same distances; the boards' work "
            f"grows with L)")
    qc = q_codes(32)
    plain_ms = gpu_ms(lambda: hamming_shortlist_plain(qc, idx.codes, L), 1)
    err = max(compare_hamming(q_codes(Q), idx.codes, L,
                              f"full size Q={Q}", full=False)
              for Q in BATCHES)
    ms, b = timed[32]
    entry = kernel_entry(
        "hamming", "src/repro_torch/csrc/hamming.cu",
        "src/repro/kernels/hamming.py:37", launches["hamming"], err, ms,
        plain_ms, b, None,
        f"hamming_shortlist Q=32 T={T} N={N} W={W} L={L}; library_ms null: "
        f"no single PyTorch call computes XOR popcounts")
    entry["by_q"] = {str(Q): {"ms": t[0], "bound_ms": t[1][0],
                              "bound_by": t[1][1]} for Q, t in timed.items()}
    kernels.append(entry)
    log(f"  hamming_shortlist Q=32: kernel {ms:.3f} ms, plain {plain_ms:.3f} "
        f"ms, bound {b[0]:.3f} ms ({b[1]}), no single library call")
    del db, idx, res
    ops.reset_launch_counts()
    torch.cuda.empty_cache()
    return recall


def lsh_breakdown(idx, queries) -> None:
    """Device ms of each lsh query stage at each batch size (CUDA events,
    stage by stage): query signatures, the hamming shortlist, the exact
    re-rank."""
    from repro_torch.core import distances as D
    from repro_torch.core.lsh import rerank, sign_codes
    from repro_torch.kernels import ops
    L = min(idx.shortlist, idx.codes.shape[1])
    for Q in BATCHES:
        q = D.l2_normalize(queries[:Q].float())
        sig = gpu_ms(lambda: sign_codes(q, idx.planes), 5)
        qc = sign_codes(q, idx.planes)
        short = gpu_ms(lambda: ops.hamming_shortlist(qc, idx.codes, L), 5)
        _, cand = ops.hamming_shortlist(qc, idx.codes, L)
        rr = gpu_ms(lambda: rerank(idx.corpus, cand, q, metric="dot", k=10),
                    5)
        log(f"  lsh stages Q={Q}: signatures {sig:.3f} ms, hamming_shortlist "
            f"{short:.3f} ms, re-rank {rr:.3f} ms (device ms, CUDA events)")


def walked_steps(codes, ids, visit, luts, coarse, spp: int, k: int,
                 Q: int) -> None:
    """The visit steps the per-query kernel scored, counted by the kernel
    itself, against the real steps of the visit table (neither on the pad
    block nor in a knocked-out probe) and against Q x T; fails unless the
    kernel scored exactly the real ones."""
    import torch
    from repro_torch.kernels import ivf_adc as K
    pad = ids.shape[0] - 1
    walked = torch.zeros(visit.shape[0], dtype=torch.int32,
                         device=visit.device)
    K._per_query_cuda(codes, ids, visit, luts, coarse, k=k,
                      steps_per_probe=spp, lut_dtype="float32",
                      pad_block=pad, walked=walked)
    live = torch.repeat_interleave(coarse > 0.5 * -1e30, spp, dim=1)
    real = (live & (visit != pad)).sum(1)
    got, want = int(walked.sum()), int(real.sum())
    log(f"  ivf_adc Q={Q}: the kernel scored {got} visit steps of "
        f"{visit.numel()} (Q x T; {got / visit.numel():.1%}), "
        f"{float(walked.float().mean()):.1f} a query (least "
        f"{int(walked.min())}, most {int(walked.max())}); real steps "
        f"{want}")
    if not torch.equal(walked.long(), real):
        raise AssertionError(f"ivf_adc Q={Q}: the kernel scored other steps "
                             "than the real ones")


def ivf_bound(ids, visit, luts, coarse, blk: int, m: int,
              lookups_per_s: float, k: int = 32, sched=None) -> tuple:
    """Least time for one IVF-ADC call on these inputs: every distinct real
    block it visits read once (codes and slot ids), the tables and the
    (Q, nprobe) coarse terms read once, the (Q, k) result written once,
    and the grid's index input read once (the (Q, T) visit table; a grouped
    grid also reads its schedule), against m table terms a scored slot,
    each a shared-memory lookup and a float32 add (``adc_bound``)."""
    import torch
    pad = ids.shape[0] - 1
    real = int((torch.unique(visit) != pad).sum())
    slots = int((ids[visit.long()] >= 0).sum())
    Q, T = visit.shape
    n_bytes = (real * blk * (m + 4) + luts.numel() * 4 + Q * T * 4
               + coarse.numel() * 4 + Q * k * 8)
    if sched is not None:
        n_bytes += sum(sched[key].numel() * 4
                       for key in ("sb", "sq", "st", "rb", "rs", "rl"))
    return adc_bound(n_bytes, float(slots) * m, lookups_per_s)


class TextEncoder:
    """The encoder callable that ``load_texts`` and ``query_texts`` take,
    built as examples/train_sbert.py builds its ``embed``: the hash
    tokenizer at a fixed seq_len, mask = tokens != 0, then ``encode`` on the
    card. Sums host seconds of tokenizing and, with ``sync``, of encoding
    (each encode then ends in a synchronize)."""

    def __init__(self, model, cfg, seq_len: int, device):
        self.model, self.cfg, self.seq_len, self.device = model, cfg, seq_len, device
        self.sync = False
        self.tokenize_s = self.encode_s = 0.0

    def tokens(self, texts):
        import numpy as np
        from repro_torch.data.marco import simple_tokenizer
        return np.stack([simple_tokenizer(t, self.cfg.vocab_size, self.seq_len)
                         for t in texts])

    def __call__(self, texts):
        import torch
        from repro_torch.models.encoder import encode
        t0 = time.perf_counter()
        tok = torch.from_numpy(self.tokens(texts)).to(self.device)
        t1 = time.perf_counter()
        self.tokenize_s += t1 - t0
        out = encode(self.model, self.cfg, tok, tok != 0)
        if self.sync:
            torch.cuda.synchronize()
            self.encode_s += time.perf_counter() - t1
        return out


def encoder_cosine(model, cfg, tokens, mask, label: str) -> float:
    """Gate: the encoder through the kernel against the same forward
    through the plain attention, row by row; an empty text is the zero
    vector on both sides."""
    import torch
    from repro_torch.models.encoder import encode
    got = encode(model, cfg, tokens, mask)
    want = encode(model, cfg, tokens, mask, use_kernel=False)
    live = mask.any(dim=1)
    cos = (got * want).sum(dim=1)
    worst = float(cos[live].min())
    zero = bool((got[~live] == 0).all()) and bool((want[~live] == 0).all())
    log(f"  {label}: encoder through the kernel against the plain attention: "
        f"min row cosine {worst:.6f} (bound >= 0.999), empty rows zero {zero}")
    if worst < 0.999 or not zero:
        raise AssertionError(f"{label}: kernel forward differs from plain")
    return worst


def encoder_breakdown(model, cfg, tok, mask) -> None:
    """Device ms of one encoder block's stages at a load batch's shape
    (CUDA events, stage by stage, on the first block's inputs), times the
    layer count, beside one whole encode."""
    import torch
    from repro_torch.models.attention import multihead_attention
    from repro_torch.models.encoder import encode
    from repro_torch.models.layers import (apply_embed, apply_mlp,
                                           apply_norm, apply_rope)
    dtype = getattr(torch, cfg.dtype)
    blk, L = model.dense_blocks[0], cfg.n_layers
    x = apply_embed(model.embed, tok, dtype)
    B, S, D = x.shape
    H, dh = cfg.n_heads, cfg.head_dim
    pos = torch.arange(S, device=x.device)[None]
    xn = apply_norm(blk.attn_norm, x)

    def qkv():
        return [(xn @ w.to(dtype).reshape(D, -1)).view(B, S, -1, dh)
                for w in (blk.attn.wq, blk.attn.wk, blk.attn.wv)]

    q, k, v = qkv()
    o = multihead_attention(q, k, v, cfg, causal=False, window=None,
                            kv_mask=mask)
    stages = {
        "two norms": lambda: (apply_norm(blk.attn_norm, x),
                              apply_norm(blk.mlp_norm, x)),
        "q, k, v projections (with the weight casts)": qkv,
        "rotary on q and k": lambda: [apply_rope(t, pos, cfg.rope_theta,
                                                 cfg.rope_pct) for t in (q, k)],
        "flash_attention": lambda: multihead_attention(
            q, k, v, cfg, causal=False, window=None, kv_mask=mask),
        "output projection": lambda: (o.reshape(B, S, H * dh)
                                      @ blk.attn.wo.to(dtype).reshape(H * dh, D)),
        "MLP (up, gelu, down)": lambda: apply_mlp(blk.mlp, xn, cfg.act),
        "two residual adds": lambda: (x + x, x + x),
    }
    total = gpu_ms(lambda: encode(model, cfg, tok, mask), 3)
    log(f"  encode B={B} S={S}: {total:.3f} ms; one block's stages (device ms, "
        f"CUDA events) x {L} layers:")
    for name, fn in stages.items():
        ms = gpu_ms(fn, 5)
        log(f"    {name}: {ms:.4f} ms, x{L} = {ms * L:.3f} ms "
            f"({100 * ms * L / total:.1f} % of encode)")


def flash_bound(B: int, S: int, H: int, dh: int) -> tuple:
    """Least time for one non-causal bf16 call: q, k, v read and o written
    once (2 bytes an element) and the (B, S) mask read once, against
    4 B H S^2 dh operations on the tensor cores."""
    return bound_ms(4 * B * S * H * dh * 2 + B * S,
                    4.0 * B * H * S * S * dh, BF16_OPS_PER_S)


def time_flash(gen, B: int, S: int, mask, device) -> dict:
    """The kernel, its plain version and F.scaled_dot_product_attention on
    the same bf16 inputs of the encoder's attention shape (H = 12, dh = 64),
    and the kernel against the plain version."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_attention_plain)
    H, dh = 12, 64
    q, k, v = (torch.randn(B, S, H, dh, generator=gen, device=device)
               .to(torch.bfloat16) for _ in range(3))
    kw = dict(causal=False, scale=dh ** -0.5, kv_mask=mask)
    reps = 20 if B * S <= 4096 else 5
    ms = gpu_ms(lambda: flash_attention_cuda(q, k, v, **kw), reps)
    plain_ms = gpu_ms(lambda: flash_attention_plain(q, k, v, **kw), 3)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    am = mask[:, None, None, :]
    lib_ms = gpu_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=am), reps)
    err = compare_flash(q, k, v, mask, False,
                        f"flash_attention at the text path's B={B} S={S}")
    b = flash_bound(B, S, H, dh)
    log(f"  flash_attention kernel B={B} S={S} H={H} dh={dh} bf16: {ms:.4f} ms "
        f"(bound {b[0]:.4f} ms, {b[1]}), plain {plain_ms:.4f} ms, "
        f"F.scaled_dot_product_attention {lib_ms:.4f} ms")
    return {"ms": ms, "plain_ms": plain_ms, "lib_ms": lib_ms, "bound": b,
            "err": err}


def phase_text(seed: int, device) -> dict:
    """Phase 5: the text path at full width; returns the flash_attention
    kernel entry."""
    import numpy as np
    import torch
    from repro_torch import VectorDB
    from repro_torch.configs import thistle_sbert
    from repro_torch.data.marco import MarcoLike
    from repro_torch.kernels import ops
    from repro_torch.models import encoder

    cfg = thistle_sbert.FULL
    log(f"phase 5: text path, {cfg.name} (layers {cfg.n_layers}, d_model "
        f"{cfg.d_model}, heads {cfg.n_heads}x{cfg.head_dim}, d_ff {cfg.d_ff}, "
        f"vocab {cfg.vocab_size}, {cfg.dtype} activations, {cfg.param_dtype} "
        f"parameters, seeded random weights), {TEXT_PASSAGES} MarcoLike "
        f"passages at seq_len {TEXT_SEQ}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    data = MarcoLike(n_passages=TEXT_PASSAGES, vocab_size=cfg.vocab_size,
                     seed=seed)
    passages = data.passage_texts()
    queries = data.query_texts(n=max(BATCHES))
    log(f"  MarcoLike passages and {len(queries)} queries: "
        f"{time.perf_counter() - t0:.2f} s (host)")
    t0 = time.perf_counter()
    model = encoder.init(cfg, torch.Generator().manual_seed(seed),
                         device=device)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"  encoder init: {time.perf_counter() - t0:.2f} s, {n_params} "
        f"parameters")
    enc = TextEncoder(model, cfg, TEXT_SEQ, device)

    ops.reset_launch_counts()
    enc.sync = True
    t0 = time.perf_counter()
    db = VectorDB("flat", metric="cosine", device=device).load_texts(
        passages, enc, batch_size=TEXT_BATCH)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    log(f"  load_texts: {wall:.2f} s = tokenize {enc.tokenize_s:.2f} s (host) "
        f"+ encode {enc.encode_s:.2f} s ({TEXT_PASSAGES // TEXT_BATCH} batches "
        f"of {TEXT_BATCH}, each ending in a synchronize) + index and the rest "
        f"{wall - enc.tokenize_s - enc.encode_s:.2f} s; "
        f"{TEXT_PASSAGES / wall:.1f} passages/s")
    enc.sync = False
    results = {}
    for Q in BATCHES:
        texts = queries[:Q]
        db.query_texts(texts, enc, k=10)  # warm-up
        torch.cuda.synchronize()
        times = []
        for _ in range(REPS[Q]):
            t1 = time.perf_counter()
            s, i, hits = db.query_texts(texts, enc, k=10)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t1)
        results[Q] = (s, i)
        log(f"  query_texts Q={Q}: p50 {percentile(times, 50) * 1e3:.3f} ms, "
            f"p99 {percentile(times, 99) * 1e3:.3f} ms (n={len(times)}), QPS "
            f"{Q * len(times) / sum(times):.1f}")
        if not (s.shape == (Q, 10) and torch.isfinite(s).all()
                and len(hits) == Q and len(hits[0]) == 10):
            raise AssertionError(f"query_texts Q={Q}: bad result")
    counts = ops.launch_counts()
    log(f"  launches on the text path (load_texts and every query_texts "
        f"batch): {counts}")
    top1 = float((results[max(BATCHES)][1][:, 0].cpu()
                  == torch.arange(max(BATCHES))).float().mean())
    log(f"  MarcoLike query -> its passage, top-1 over {max(BATCHES)} queries: "
        f"{top1:.4f} (random weights; printed, not gated)")

    # stage split at each Q (CUDA events, stage by stage)
    for Q in BATCHES:
        t1 = time.perf_counter()
        tok = enc.tokens(queries[:Q])
        tok_ms = (time.perf_counter() - t1) * 1e3
        tok = torch.from_numpy(tok).to(device)
        emb = encoder.encode(model, cfg, tok, tok != 0)
        enc_ms = gpu_ms(lambda: encoder.encode(model, cfg, tok, tok != 0), 5)
        search_ms = gpu_ms(lambda: db.query(emb, k=10), 5)
        log(f"  text stages Q={Q}: tokenize {tok_ms:.3f} ms (host), encode "
            f"{enc_ms:.3f} ms, search {search_ms:.3f} ms (device ms, CUDA "
            f"events)")

    tok = torch.from_numpy(enc.tokens(passages[:TEXT_BATCH])).to(device)
    encoder_breakdown(model, cfg, tok, tok != 0)

    # gate 2: passages sent back as queries find themselves
    n_self = max(BATCHES)
    _, ids, _ = db.query_texts(passages[:n_self], enc, k=10)
    found = float((ids.cpu() == torch.arange(n_self)[:, None]).any(dim=1)
                  .float().mean())
    log(f"  {n_self} passages sent back through query_texts: in their own "
        f"top 10 {found:.4f} (bound >= 0.99)")
    if found < 0.99:
        raise AssertionError(f"self-retrieval {found:.4f} below 0.99")

    # gate 1: the encoder through the kernel against the plain attention,
    # at the load's seq_len and at max_seq_len with lengths 1..512
    tok = torch.from_numpy(enc.tokens(passages[:32])).to(device)
    encoder_cosine(model, cfg, tok, tok != 0, "B=32 S=64")
    gen = torch.Generator(device=device).manual_seed(seed + 4)
    S = cfg.max_seq_len
    long_mask = ragged_mask(gen, 32, S, device, empty_row=False)
    long_mask[1] = torch.arange(S, device=device) < 1
    long_tok = torch.randint(2, cfg.vocab_size, (32, S), generator=gen,
                             device=device)
    long_tok = torch.where(long_mask, long_tok, 0)
    long_ms = gpu_ms(lambda: encoder.encode(model, cfg, long_tok, long_mask), 3)
    log(f"  encode B=32 S={S} (lengths 1..{S}): {long_ms:.3f} ms (device ms, "
        f"CUDA events)")
    encoder_cosine(model, cfg, long_tok, long_mask, f"B=32 S={S}")

    # the kernel at each shape the path gives it
    timed = {}
    for B, S in TEXT_FLASH_SHAPES:
        if S == TEXT_SEQ:
            t = torch.from_numpy(enc.tokens(passages[:B])).to(device)
            mask = t != 0
        else:
            mask = long_mask[:B]
        timed[(B, S)] = time_flash(gen, B, S, mask, device)

    # gate 3
    if counts["flash_attention"] <= 0:
        raise AssertionError("flash_attention never launched on the text path")
    peak = torch.cuda.max_memory_allocated()
    log(f"  peak device memory in the text phase: {peak / 1e9:.2f} GB")
    main = timed[(TEXT_BATCH, TEXT_SEQ)]
    del db, model, enc
    torch.cuda.empty_cache()
    return kernel_entry(
        "flash_attention", "src/repro_torch/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:70", counts["flash_attention"],
        max(t["err"] for t in timed.values()), main["ms"], main["plain_ms"],
        main["bound"], main["lib_ms"],
        f"B={TEXT_BATCH} S={TEXT_SEQ} H=12 dh=64 bf16 non-causal with the "
        f"passages' key-padding mask (a load_texts batch); library_ms: "
        f"F.scaled_dot_product_attention with the same boolean mask")


# ------------------------------------------------ phase 6: writes, serving
MUT_INSERT = 88_418      # 1 % of the passages: new rows
MUT_DELETE = 884_182     # 10 %: random live ids tombstoned
MUT_UPSERT = 88_418      # 1 %: existing ids re-encoded with fresh vectors
MUT_BATCH = {"insert": 1024, "delete": 8192, "upsert": 1024}
SELF_QUERIES = 4096      # rows sent back as queries, of each kind
SELF_MARGIN = 0.02       # written rows found at least as often as loaded ones
                         # less this (5 standard deviations of the difference
                         # of two rates near 0.93 over 4,096 rows each)
SERVE_READS = 2048       # single-query reads a stream
SERVE_EVERY = 8          # one write after every 8 reads (interleaved_1to8)
SERVE_ROWS = 64          # rows a write
SERVE_BATCH = 64         # the fronts' max_batch


def counted(acc: dict, fn, *args, **kw):
    """fn(*args, **kw), adding the kernel launches it made to ``acc``: the
    phase counts the launches of its path, not of its comparisons."""
    from repro_torch.kernels import ops
    before = ops.launch_counts()
    out = fn(*args, **kw)
    for name, c in ops.launch_counts().items():
        acc[name] = acc.get(name, 0) + c - before[name]
    return out


def apply_writes(db, kind: str, total: int, batch: int, vectors=None,
                 ids=None, label: str = "") -> list:
    """Apply ``total`` rows of one write kind in batches; logs rows/s (host
    clock around the batches, ending in a synchronize). Returns the
    writes' results."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = []
    for a in range(0, total, batch):
        b = min(total, a + batch)
        if kind == "insert":
            outs.append(db.insert(vectors[a:b]))
        elif kind == "delete":
            outs.append(db.delete(ids[a:b]))
        else:
            outs.append(db.upsert(vectors[a:b], ids[a:b]))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    log(f"  {label}{kind} {total} rows in batches of {batch}: {secs:.3f} s, "
        f"{total / secs:.1f} rows/s (host clock, synced)")
    return outs


def write_mix(db, n: int, seed: int, device, rank: int, label: str = ""):
    """The reference's mutation mix (BENCH_mutation.json's paths) scaled to
    n rows: inserts of 1 % new rows, deletes of 10 % random loaded ids,
    upserts of 1 % other loaded ids with fresh vectors (so the inserted
    rows stay as written). Returns (inserted ids, their vectors, upserted
    ids, their vectors, deleted ids)."""
    import torch
    n_ins, n_del, n_ups = n // 100, n // 10, n // 100
    ins_vecs = new_rows(n_ins, n, seed, 1, device, rank)
    ins_ids = torch.cat(apply_writes(db, "insert", n_ins, MUT_BATCH["insert"],
                                     vectors=ins_vecs, label=label))
    gen = torch.Generator(device=device).manual_seed(seed + 3)
    perm = torch.randperm(n, generator=gen, device=device)  # loaded rows
    dead, ups_ids = perm[:n_del], perm[n_del:n_del + n_ups]
    deleted = sum(apply_writes(db, "delete", n_del, MUT_BATCH["delete"],
                               ids=dead, label=label))
    if deleted != n_del:
        raise AssertionError(f"{label}deleted {deleted} of {n_del} live ids")
    ups_vecs = new_rows(n_ups, n, seed, 2, device, rank)
    apply_writes(db, "upsert", n_ups, MUT_BATCH["upsert"], vectors=ups_vecs,
                 ids=ups_ids, label=label)
    want = n + n_ins - n_del
    if db.index.size != want or db.n != want:
        raise AssertionError(f"{label}size {db.index.size} after the writes, "
                             f"expected {want}")
    return ins_ids, ins_vecs, ups_ids, ups_vecs, dead


def no_dead_ids(ids, dead_mask, label: str) -> None:
    got = ids[ids >= 0].long()
    if bool(dead_mask[got].any()):
        raise AssertionError(f"{label}: a deleted id in the results")


def equal_up_to_ties(a, b, label: str) -> None:
    """Scores bit-equal rank by rank; ids equal but where the score at
    that rank ties with a neighbour's."""
    import torch
    (s0, i0), (s1, i1) = a, b
    same_s = (s0 == s1) | (torch.isneginf(s0) & torch.isneginf(s1))
    if not bool(same_s.all()):
        raise AssertionError(f"{label}: scores differ")
    tie = torch.zeros_like(s0, dtype=torch.bool)
    tie[:, 1:] |= s0[:, 1:] == s0[:, :-1]
    tie[:, :-1] |= s0[:, :-1] == s0[:, 1:]
    diff = i0 != i1
    if bool((diff & ~tie).any()):
        raise AssertionError(f"{label}: ids differ outside ties")
    log(f"  {label}: scores bit-equal, ids equal at "
        f"{float((~diff).float().mean()):.4f} of ranks (the rest ties)")


def self_found(db, vecs, ids, label: str) -> float:
    """Share of rows, sent back as queries (batches of 512), found in their
    own top 10."""
    import torch
    got = torch.cat([db.query(vecs[a:a + 512], k=10)[1]
                     for a in range(0, vecs.shape[0], 512)])
    rate = float((got.long() == ids.long()[:, None]).any(1).float().mean())
    log(f"  {label}: {rate:.4f} of {vecs.shape[0]} found in their own top 10")
    return rate


def rows_in_layout(idx, ids, vecs, what: str) -> None:
    """Every written id sits in one slot of the layout, in the block list
    of the cluster its row is assigned to, with the codes its row encodes
    to (the engine's encode, in the batches it was written in)."""
    import torch
    lay = idx.layout
    pos = lay.pos[ids]
    if not bool((pos >= 0).all()):
        raise AssertionError(f"a {what} id is missing from the layout")
    enc = [idx._encode_batch(vecs[a:a + MUT_BATCH["insert"]])
           for a in range(0, vecs.shape[0], MUT_BATCH["insert"])]
    codes = torch.cat([e[0] for e in enc])
    assign = torch.cat([e[1] for e in enc])
    if not (torch.equal(lay.slots.view(-1)[pos].long(), ids.long())
            and torch.equal(lay.block_cluster[pos // lay.blk].long(),
                            assign.long())
            and torch.equal(lay.codes.view(-1, lay.m)[pos], codes)):
        raise AssertionError(f"a {what} row's slot, cluster or codes differ "
                             "from its encode")
    log(f"  all {ids.numel()} {what} ids sit in their cluster's block list "
        "with the codes their rows encode to")


def layout_facts(idx) -> str:
    lay = idx.layout
    return (f"storage rows {lay.capacity}, blocks {lay.n_blocks}, "
            f"steps_per_probe {lay.steps_per_probe}, re-rank corpus rows "
            f"{idx._corpus.capacity}, live {lay.live}, tombstones "
            f"{lay.tombstones} ({lay.tombstone_fraction:.4f})")


def grid_times(idx, queries, lookups_per_s: float, label: str) -> dict:
    """The three ivf_adc kernels at each Q of BATCHES on the engine's
    current layout: ms (CUDA events) beside the bound, and the visit steps
    the per-query kernel scored against the real ones (``walked_steps``
    fails unless equal). Returns {name: {Q: (ms, bound)}}."""
    from repro_torch.kernels import ivf_adc as K
    from repro_torch.kernels import ops
    k, blk, m = idx.refine, idx.block_size, idx.codebooks.shape[0]
    out = {n: {} for n in ("ivf_adc", "ivf_adc_blocked",
                           "ivf_adc_run_resident")}
    for Q in BATCHES:
        codes, ids, visit, luts, coarse, spp = probe_inputs(idx, queries[:Q])
        pad = ids.shape[0] - 1
        sched = ops.build_schedule(visit, qblk=8, pad_block=pad)
        calls = {
            "ivf_adc": lambda: K.ivf_adc_cuda(codes, ids, visit, luts, coarse,
                                              k=k, steps_per_probe=spp,
                                              pad_block=pad),
            "ivf_adc_blocked": lambda: K.ivf_adc_blocked_cuda(
                codes, ids, visit, sched, luts, coarse, k=k,
                steps_per_probe=spp),
            "ivf_adc_run_resident": lambda: K.ivf_adc_run_resident_cuda(
                codes, ids, visit, sched, luts, coarse, k=k,
                steps_per_probe=spp)}
        parts = []
        for name, fn in calls.items():
            ms = gpu_ms(fn, 5)
            b = ivf_bound(ids, visit, luts, coarse, blk, m, lookups_per_s, k,
                          None if name == "ivf_adc" else sched)
            out[name][Q] = (ms, b)
            parts.append(f"{name} {ms:.3f} ms (bound {b[0]:.3f}, {b[1]})")
        log(f"  {label} Q={Q} (T={visit.shape[1]}): " + ", ".join(parts))
        walked_steps(codes, ids, visit, luts, coarse, spp, k, Q)
    return out


def serve_modes(db, queries, dead, label: str) -> dict:
    """Every adc_mode over the batches; no deleted id anywhere; auto,
    blocked and run_resident equal per_query bit for bit."""
    idx = db.index
    res = {}
    for mode in ("auto", "per_query") + GROUPED:
        idx.adc_mode = mode
        res[mode] = serve_batches(db, queries, f"ivf_pq {mode} {label}")
        for Q in BATCHES:
            no_dead_ids(res[mode][Q][1], dead, f"{mode} {label} Q={Q}")
    for mode in ("auto",) + GROUPED:
        for Q in BATCHES:
            if not same_result(res[mode][Q], res["per_query"][Q]):
                raise AssertionError(f"ivf_pq {mode} {label} Q={Q} differs "
                                     "from per_query")
    log(f"  {label}: no deleted id at Q = {BATCHES} under any adc_mode; "
        "auto, blocked and run_resident equal per_query bit for bit")
    idx.adc_mode = "auto"
    return res


def kernel_against_plain(idx, queries, label: str) -> None:
    """The three grids on the mutated layout against their plain versions
    (the grouped ones also against the per-query kernel), bit for bit."""
    for Q in (1, 32):
        args = probe_inputs(idx, queries[:Q])
        kw = dict(k=idx.refine, spp=args[5], lut_dtype="float32")
        compare_ivf(*args[:5], **kw, label=f"ivf_adc {label} Q={Q}")
        for mode in GROUPED:
            compare_grouped(*args[:5], mode=mode, qblk=8, **kw,
                            label=f"ivf_adc_{mode} {label} Q={Q}")


def live_truth(idx, queries, label: str, acc: dict):
    """Exact top 10 over the live rows (flat_search through topk_distance
    on the engine's re-rank corpus under the layout's live mask, its
    launches counted in ``acc``), and that kernel held against its plain
    version at Q = 32."""
    import torch
    from repro_torch.core.flat import flat_search
    valid = torch.zeros(idx._corpus.capacity, dtype=torch.bool,
                        device=queries.device)
    valid[: idx.n] = idx.layout.live_mask(idx.n)
    _, truth = counted(acc, flat_search, idx._corpus.data, queries,
                       metric="cosine", k=10, valid=valid)
    compare_topk(idx._corpus.data,
                 queries[:32] / torch.linalg.vector_norm(
                     queries[:32], dim=1, keepdim=True),
                 "dot", 10, f"topk_distance live rows {label} Q=32",
                 valid=valid)
    return truth


def stream_script(db, queries, n: int, seed: int, salt: int, device,
                  rank: int):
    """The interleaved_1to8 stream: SERVE_READS single-query reads (k = 10)
    and after every SERVE_EVERY of them one write of SERVE_ROWS rows,
    inserts and deletes in turn. An insert's first row is an isotropic
    random unit vector, far from every cluster, and the read after it
    queries that row: it finds the row whenever the insert came first (a
    clustered row is found in its own top 10 only as often as the ADC cut
    keeps it, about 93 %). A delete takes the 64 best ids of the read
    after it (found before the stream). Returns the ops, in order."""
    import torch
    n_writes = SERVE_READS // SERVE_EVERY
    fresh = new_rows(n_writes * SERVE_ROWS, n, seed, salt, device, rank)
    gen = torch.Generator(device=device).manual_seed(seed + salt)
    probe = torch.randn(n_writes, DIM, generator=gen, device=device)
    fresh[::SERVE_ROWS] = probe / torch.linalg.vector_norm(probe, dim=1,
                                                            keepdim=True)
    fresh = fresh.cpu()
    host_q = queries.cpu()
    after_delete = [host_q[(w * SERVE_EVERY + SERVE_EVERY) % host_q.shape[0]]
                    for w in range(n_writes)]
    victims = db.query(torch.stack(after_delete).to(device), k=SERVE_ROWS,
                       bucketize=False)[1].cpu()
    ops_, last = [], None
    for i in range(SERVE_READS):
        if i and i % SERVE_EVERY == 0:
            w = i // SERVE_EVERY - 1
            if w % 2 == 0:
                last = ("insert", fresh[w * SERVE_ROWS:(w + 1) * SERVE_ROWS])
                ops_.append(("write", "insert", last[1], None))
            else:
                last = ("delete", victims[w])
                ops_.append(("write", "delete", None, victims[w]))
        if last is not None and last[0] == "insert":
            ops_.append(("read", last[1][0], "new"))
        elif last is not None:
            ops_.append(("read", after_delete[i // SERVE_EVERY - 1], None))
        else:
            ops_.append(("read", host_q[i % host_q.shape[0]], None))
        last = None
    return ops_


def check_stream(ops_, results, label: str) -> None:
    """Read-your-writes on a stream's results: the read after an insert
    finds the id of the row it queries; no read returns an id deleted
    before it."""
    deleted, new_id, found, n_new = set(), None, 0, 0
    for op, res in zip(ops_, results):
        if op[0] == "write":
            kind, out = res
            if kind == "insert":
                new_id = int(out[0])
            else:
                deleted.update(int(i) for i in op[3].tolist() if i >= 0)
            continue
        ids = set(res[1].tolist())
        if ids & deleted:
            raise AssertionError(f"{label}: a read returned an id deleted "
                                 "before it")
        if op[2] == "new":
            n_new += 1
            found += new_id in ids
    if found != n_new:
        raise AssertionError(f"{label}: {n_new - found} of {n_new} reads "
                             "behind an insert missed the inserted row")
    log(f"  {label}: {n_new} reads behind an insert found the new row; no "
        f"read saw any of the {len(deleted)} ids deleted before it")


def run_pump(db, ops_) -> tuple:
    """The stream through QueryEngine: everything queued, then drained.
    Returns (results in op order, latency_stats, seconds from the first
    submit to the last result, read batches)."""
    from repro_torch.serve import QueryEngine
    plans = sum(db.plan_stats.values())
    eng = QueryEngine(db, max_batch=SERVE_BATCH, max_wait_ms=2.0)
    t0 = time.perf_counter()
    rids = [eng.submit(op[1], 10) if op[0] == "read"
            else eng.submit_write(op[1], op[2], op[3]) for op in ops_]
    eng.drain()
    secs = time.perf_counter() - t0
    return ([eng.result(r) for r in rids], eng.latency_stats(), secs,
            sum(db.plan_stats.values()) - plans)


def run_async(db, ops_, queued: bool) -> tuple:
    """The stream through AsyncQueryEngine from one submitting thread:
    ``queued`` submits it all before the engine starts (the pump's
    setting), else the engine serves while the thread submits. Returns
    as ``run_pump``."""
    from repro_torch.serve import AsyncQueryEngine
    plans = sum(db.plan_stats.values())
    eng = AsyncQueryEngine(db, max_batch=SERVE_BATCH, max_wait_ms=2.0,
                           max_queue=4096, start=not queued)
    with eng:
        t0 = time.perf_counter()
        futs = [eng.submit(op[1], 10) if op[0] == "read"
                else eng.submit_write(op[1], op[2], op[3]) for op in ops_]
        eng.start()
        results = [f.result(timeout=600) for f in futs]
        secs = time.perf_counter() - t0
    return (results, eng.latency_stats(), secs,
            sum(db.plan_stats.values()) - plans)


FRONTS = (("QueryEngine", run_pump),
          ("AsyncQueryEngine queued", lambda db, o: run_async(db, o, True)),
          ("AsyncQueryEngine live", lambda db, o: run_async(db, o, False)))


def log_front(name: str, stats: dict, secs: float, batches: int,
              n_reads: int) -> None:
    log(f"  {name}: {n_reads} reads in {secs:.3f} s, QPS {n_reads / secs:.1f}, "
        f"{batches} read batches, p50 {stats['p50_ms']:.3f} ms, p99 "
        f"{stats['p99_ms']:.3f} ms (enqueue to result), queue_depth_max "
        f"{stats.get('queue_depth_max', '-')}, plan hits "
        f"{stats['plan_hits']} misses {stats['plan_misses']}, writes "
        + str({k: v for k, v in stats.items() if k.startswith('write_')}))


def ids_match_oracle(results, oracle, label: str) -> None:
    """A front's read ids against the oracle's rows: equal, but where two
    ids' scores agree within 1e-6 (two launches may round the re-rank's
    float32 sums differently)."""
    import torch
    s_o, i_o = oracle
    swaps = 0
    for r, (s, i) in enumerate(results):
        diff = torch.nonzero(i != i_o[r])[:, 0]
        for j in diff.tolist():
            where = torch.nonzero(i_o[r] == i[j])[:, 0]
            other = s_o[r, where[0]] if where.numel() else s_o[r, -1]
            if abs(float(other) - float(s[j])) > 1e-6:
                raise AssertionError(f"{label}: read {r} differs from "
                                     "db.query(bucketize=False)")
            swaps += 1
    log(f"  {label}: ids equal db.query(bucketize=False) row by row "
        f"({swaps} swaps within 1e-6)")


def phase_serving(db, queries, n: int, seed: int, device, rank: int) -> None:
    """Both serving fronts on the mutated full-size index (the async one
    with the stream queued before it starts, as the pump drains it, and
    live, serving while one thread submits): the mixed stream
    (read-your-writes) under auto, then a read-only stream under auto and
    per_query against db.query(bucketize=False)."""
    import torch
    for salt, (name, run) in zip((5, 6, 7), FRONTS):
        ops_ = stream_script(db, queries, n, seed, salt, device, rank)
        results, stats, secs, batches = run(db, ops_)
        log_front(f"{name} interleaved_1to8", stats, secs, batches,
                  SERVE_READS)
        check_stream(ops_, results, f"{name} interleaved_1to8")
    host_q = queries.cpu()
    reads = [host_q[i % host_q.shape[0]] for i in range(SERVE_READS)]
    oracle = tuple(x.cpu() for x in db.query(torch.stack(reads).to(device),
                                            k=10, bucketize=False))
    # auto syncs the host inside every batch (its sharing probe), so a
    # batcher cannot run ahead of the card; per_query's path has no sync
    for mode in ("auto", "per_query"):
        db.index.adc_mode = mode
        for name, run in FRONTS:
            results, stats, secs, batches = run(db, [("read", q, None)
                                                     for q in reads])
            log_front(f"{name} read-only {mode}", stats, secs, batches,
                      SERVE_READS)
            ids_match_oracle(results, oracle, f"{name} read-only {mode}")
    db.index.adc_mode = "auto"


def phase_mutation(n: int, seed: int, device, rank: int, rates: dict,
                   min_recall: float, p4_recall: float) -> dict:
    """Phase 6: writes on ivf_pq at full size, both serving fronts on the
    mutated index, then writes on flat (float32, bf16) and pq at mid size.
    Returns {kernel name: {launches, ...}} for the kernels line."""
    import torch
    from repro_torch import VectorDB
    from repro_torch.core import distances as D
    log(f"phase 6: mutation and serving, ivf_pq N={n}, d={DIM}, cosine, m="
        f"{M_SUBSPACES}: insert {n // 100} new rows (batches of "
        f"{MUT_BATCH['insert']}), delete {n // 10} live ids (batches of "
        f"{MUT_BATCH['delete']}), upsert {n // 100} ids (batches of "
        f"{MUT_BATCH['upsert']}), compact")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    corpus, queries = make_dataset(n, max(BATCHES), seed, device, rank)
    db = VectorDB("ivf_pq", metric="cosine", m=M_SUBSPACES,
                  device=device).load(corpus)
    torch.cuda.synchronize()
    del corpus  # the engine keeps its own normalized copy
    torch.cuda.empty_cache()
    idx = db.index
    log(f"  load {time.perf_counter() - t0:.2f} s (data made on the card and "
        f"ivf_pq trained); the data's copy dropped, device memory in use "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB; {layout_facts(idx)}; "
        f"plan_generation {db.plan_generation}")
    path = {}  # launches of the phase's path: its writes, queries, serving
    counted(path, serve_batches, db, queries, "ivf_pq auto before the writes")
    grid_times(idx, queries, rates["lookups"], "before the writes")
    orig = torch.arange(SELF_QUERIES, device=device)
    baseline = self_found(db, idx._corpus.data[orig], orig,
                          "loaded rows (the baseline)")

    ins_ids, ins_vecs, ups_ids, ups_vecs, _ = counted(
        path, write_mix, db, n, seed, device, rank)
    dead = ~idx.layout.live_mask(idx.n)
    log(f"  after the writes: {layout_facts(idx)}; plan_generation "
        f"{db.plan_generation}; device memory in use "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    for ids, vecs, what in ((ins_ids, ins_vecs, "inserted"),
                            (ups_ids, ups_vecs, "upserted")):
        want = torch.cat([D.preprocess_corpus(vecs[a:a + 1024], "cosine")[0]
                          for a in range(0, vecs.shape[0], 1024)])
        if not torch.equal(idx._corpus.data[ids], want):
            raise AssertionError(f"re-rank rows of the {what} ids differ from "
                                 "preprocess_corpus of the vectors written")
    log("  re-rank rows of the inserted and upserted ids equal "
        "preprocess_corpus of the vectors written, bit for bit")
    for ids, vecs, what in ((ins_ids, ins_vecs, "inserted"),
                            (ups_ids, ups_vecs, "upserted")):
        rows_in_layout(idx, ids, vecs, what)
        rate = self_found(db, vecs[:SELF_QUERIES], ids[:SELF_QUERIES],
                          f"{what} rows")
        if rate < baseline - SELF_MARGIN:
            raise AssertionError(f"{what} rows found in their own top 10 "
                                 f"{rate:.4f}, loaded rows {baseline:.4f}")
    before = counted(path, serve_modes, db, queries, dead, "after the writes")
    kernel_against_plain(idx, queries, "mutated")
    times = grid_times(idx, queries, rates["lookups"], "after the writes")
    truth = live_truth(idx, queries, "after the writes", path)
    recall = recall_at_10(before["per_query"][max(BATCHES)][1], truth)
    log(f"  recall@10 of ivf_pq against the exact top 10 over the live rows: "
        f"{recall:.4f} (phase 4, before any write: {p4_recall:.4f})")
    if recall < min_recall:
        raise AssertionError(f"recall@10 after the writes {recall:.4f} "
                             f"below {min_recall}")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stats = counted(path, db.compact)
    torch.cuda.synchronize()
    log(f"  compact: {time.perf_counter() - t0:.3f} s, {stats}; "
        f"{layout_facts(idx)}; plan_generation {db.plan_generation}")
    after = counted(path, serve_modes, db, queries, dead, "after compact")
    for Q in BATCHES:
        equal_up_to_ties(before["per_query"][Q], after["per_query"][Q],
                         f"per_query Q={Q} after compact against before")
    kernel_against_plain(idx, queries, "compacted")
    grid_times(idx, queries, rates["lookups"], "after compact")
    counted(path, phase_serving, db, queries, n, seed, device, rank)
    counts = path
    log(f"  launches on the phase's path (writes, queries, serving; not the "
        f"comparisons and timings): {counts}")
    out = {}
    for name in ("ivf_adc", "ivf_adc_blocked", "ivf_adc_run_resident",
                 "topk_distance"):
        if counts[name] <= 0:
            raise AssertionError(f"{name} never launched on the mutated index")
        out[name] = {"launches": counts[name]}
        if name in times:
            out[name].update({f"ms_q{Q}": t[0] for Q, t in times[name].items()})
            out[name].update({f"bound_ms_q{Q}": t[1][0]
                              for Q, t in times[name].items()})
    log(f"  peak device memory in the phase: "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del db, idx, queries, truth, before, after, ins_vecs, ups_vecs
    torch.cuda.empty_cache()
    mid = mutation_mid(seed, device, rank)
    for name, c in mid.items():
        out.setdefault(name, {"launches": 0})
        out[name]["mid_launches"] = c
    return out


def mutation_mid(seed: int, device, rank: int) -> dict:
    """flat (float32, bf16) and pq at MID_ROWS under the same write mix,
    scaled: kernel path against plain path on the mutated buffers, and the
    float32 flat against brute force over the live rows. Returns the
    kernels' launches."""
    import torch
    from repro_torch import VectorDB
    from repro_torch.core import distances as D
    corpus, queries = make_dataset(MID_ROWS, 512, seed + 1, device, rank)
    q32 = queries[:32]
    launches = {}
    for engine, kw in (("flat", {}), ("flat", {"dtype": torch.bfloat16}),
                       ("pq", {"m": M_SUBSPACES})):
        label = f"{engine}{' bf16' if kw.get('dtype') else ''} N={MID_ROWS} "
        db = VectorDB(engine, metric="cosine", device=device, **kw).load(corpus)
        ins_ids, ins_vecs, ups_ids, ups_vecs, dead_ids = counted(
            launches, write_mix, db, MID_ROWS, seed + 1, device, rank, label)
        counted(launches, db.compact)
        s, i = counted(launches, db.query, queries, k=10)
        idx = db.index
        idx._sync()
        no_dead_ids(i, ~idx.valid, f"{label}after the writes")
        if engine == "flat":
            qd = D.l2_normalize(q32.to(idx.corpus.dtype))
            compare_topk(idx.corpus, qd, "dot", 10, f"{label}mutated kernel "
                         "against plain Q=32", valid=idx.valid)
            if not kw:
                brute_force(corpus, queries, ins_vecs, ups_ids, ups_vecs,
                            dead_ids, (s, i), label)
        else:
            codes, luts, valid = pq_inputs(idx, q32)
            compare_pq(codes, luts, k=32, lut_dtype="float32", valid=valid,
                       label=f"{label}mutated pq_adc Q=32")
        del db, idx
        torch.cuda.empty_cache()
    for name in ("topk_distance", "pq_adc"):
        if launches.get(name, 0) <= 0:
            raise AssertionError(f"{name} never launched at mid size")
    del corpus, queries
    torch.cuda.empty_cache()
    return {name: launches[name] for name in ("topk_distance", "pq_adc")}


def brute_force(corpus, queries, ins_vecs, ups_ids, ups_vecs, dead_ids,
                got, label: str) -> None:
    """The float32 flat engine's answer against brute force over the live
    rows, built apart from the engine: the loaded rows, the inserted ones
    appended, the upserted ones replaced, the deleted ones masked."""
    import torch
    from repro_torch.core import distances as D
    rows = D.l2_normalize(torch.cat([corpus, ins_vecs]))
    rows[ups_ids] = D.l2_normalize(ups_vecs)
    live = torch.ones(rows.shape[0], dtype=torch.bool, device=rows.device)
    live[dead_ids] = False
    live[ups_ids] = True
    q = D.l2_normalize(queries)
    exact = (q.double() @ rows.double().T).masked_fill(~live[None], -math.inf)
    order = torch.sort(exact, dim=1, descending=True, stable=True)
    ref_s, ref_i = order.values[:, :10], order.indices[:, :10]
    s, i = got
    tol = topk_tolerance(rows, q, False)[:, None]
    if not bool(((s.double() - ref_s).abs() <= tol).all()):
        raise AssertionError(f"{label}scores differ from brute force beyond "
                             "compare_topk's bound")
    diff = i.long() != ref_i
    rows_, cols = torch.nonzero(diff, as_tuple=True)
    gap = (exact[rows_, i[rows_, cols].long()] - ref_s[rows_, cols]).abs()
    if not bool((gap <= 2 * tol[rows_, 0]).all()):
        raise AssertionError(f"{label}ids differ from brute force beyond "
                             "near-ties")
    log(f"  {label}against brute force over the live rows (float64): ids "
        f"agree {float((~diff).float().mean()):.4f} (bound: all but "
        f"near-ties), max |dscore| {float((s.double() - ref_s).abs().max()):.3e}")

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=MARCO_PASSAGES,
                    help="corpus rows of the main phase")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rank", type=int, default=8,
                    help="rank of the subspace the centres share; 0 gives "
                         "unit centres plus isotropic noise")
    ap.add_argument("--min-recall", type=float, default=0.5,
                    help="fail below this recall@10 of ivf_pq or lsh against "
                         "flat (pq's is printed, not gated)")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()
    smi, rates = phase_header()
    t0 = time.perf_counter()
    phase_build()
    log(f"[phase 2: {time.perf_counter() - t0:.1f} s]")
    t0 = time.perf_counter()
    phase_mid(args.seed, device, args.rank)
    log(f"[phase 3: {time.perf_counter() - t0:.1f} s]")
    t0 = time.perf_counter()
    kernels, recalls = phase_main(args.n, args.seed, device, args.rank,
                                  args.min_recall, rates)
    log(f"[phase 4: {time.perf_counter() - t0:.1f} s]")
    t0 = time.perf_counter()
    kernels.append(phase_text(args.seed, device))
    log(f"[phase 5: {time.perf_counter() - t0:.1f} s]")
    t0 = time.perf_counter()
    mutated = phase_mutation(args.n, args.seed, device, args.rank, rates,
                             args.min_recall, recalls["ivf_pq"])
    for entry in kernels:
        if entry["name"] in mutated:
            entry["mutation_phase"] = mutated[entry["name"]]
    log(f"[phase 6: {time.perf_counter() - t0:.1f} s]")
    leaked = [m for m in sys.modules
              if m == "jax" or m.startswith("jax.") or m == "repro"
              or m.startswith("repro.")]
    if leaked:
        raise AssertionError(f"imported the JAX side: {leaked[:5]}")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(smi)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
