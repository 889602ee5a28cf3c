#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--n ROWS] [--seed S] [--rank R] [--min-recall X]

Phases, in order; any failure raises and the script exits non-zero:
  1. header: the card's name and power limit (nvidia-smi), torch and CUDA;
  2. build: both CUDA kernels, one nvcc each, in parallel; the ptxas lines
     (registers, shared memory, spills);
  3. kernel against plain version at mid size (262,144 rows, d = 768,
     m = 64): ``topk_distance`` for {dot, l2} x k in {10, 200} x Q in
     {1, 32, 512}, ``ivf_adc`` for {dot, l2, cosine} x {float32, bfloat16,
     int8} x Q in {1, 32, 512}, each against its stated bound;
  4. main path at full size: ``VectorDB("flat")`` then ``VectorDB("ivf_pq")``
     on the MS MARCO v1 passage count (8,841,823 rows) of d = 768 cosine
     embeddings, clustered synthetic data made on the card from ``--seed``;
     load seconds, p50/p99 latency and QPS at Q = 1, 32, 512, each
     kernel's time beside its bound, the plain version's and a library
     call's time, launches on the main path, recall@10 of ivf_pq against
     flat, peak device memory, and full-size batches of each kernel against
     its plain version (``topk_distance`` at Q = 1, 32, 512, ``ivf_adc`` at
     Q = 1, 32);
  5. a JSON line of the kernels, then the result line.

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
HBM_BYTES_PER_S = 3.35e12    # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores


def log(*args) -> None:
    print(*args, flush=True)


# ----------------------------------------------------------------- data
def clustered_rows(n: int, d: int, gen, device, *, n_centres: int,
                   rank: int = 8, spread: float = 0.35, noise: float = 0.01,
                   chunk: int = 1 << 18):
    """Unit rows around ``n_centres`` random unit centres: each row is its
    centre plus a draw from a ``rank``-dimensional subspace shared by all
    centres (scale ``spread``) plus isotropic noise, normalized. Made on
    ``device`` from ``gen``, a chunk of rows at a time."""
    import torch
    centres = torch.randn(n_centres, d, generator=gen, device=device)
    centres /= torch.linalg.vector_norm(centres, dim=1, keepdim=True)
    basis = torch.randn(rank, d, generator=gen, device=device) / math.sqrt(d)
    out = torch.empty((n, d), dtype=torch.float32, device=device)
    for a in range(0, n, chunk):
        b = min(n, a + chunk)
        which = torch.randint(n_centres, (b - a,), generator=gen, device=device)
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


def bound_ms(n_bytes: float, n_ops: float) -> tuple:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def percentile(xs, p: float) -> float:
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(math.ceil(p / 100 * len(xs))) - 1)]


def serve_batches(db, queries, label: str) -> dict:
    """Run the query batches through the front; host clock around work
    that ends in a synchronize. Returns {Q: (scores, ids)} of the last rep."""
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
            f"(n={len(times)}), QPS {Q * len(times) / sum(times):.1f}")
        if not (torch.isfinite(s[:, 0]).all() and s.shape == (Q, 10)):
            raise AssertionError(f"{label} Q={Q}: bad result {tuple(s.shape)}")
    return last


# --------------------------------------------------------- comparisons
def topk_tolerance(corpus, q, l2: bool):
    """Bound on |kernel - plain| for one score: both sum d products in
    float32 in different orders, each within d * 2^-24 * |q| * |c| of the
    exact dot (x2 for l2), plus a few roundings of the score itself."""
    import torch
    c_max = float(torch.linalg.vector_norm(corpus, dim=1).max())
    q_norm = torch.linalg.vector_norm(q, dim=1)
    d = corpus.shape[1]
    return (2.0 if l2 else 1.0) * 2 * d * 2.0 ** -24 * q_norm * c_max


def compare_topk(corpus, q, metric: str, k: int, label: str) -> float:
    """ops.topk_distance on the kernel and on the plain version. Scores
    agree rank by rank within the tolerance; an id may differ only where
    the kernel's row scores, exactly in float64, within twice the tolerance
    of the plain version's score at that rank (a near-tie)."""
    import torch
    from repro_torch.kernels import ops
    sq = torch.sum(corpus * corpus, dim=1) if metric == "l2" else None
    ks, ki = ops.topk_distance(corpus, q, k=k, metric=metric, corpus_sq=sq,
                               use_kernel=True)
    ps, pi = ops.topk_distance(corpus, q, k=k, metric=metric, corpus_sq=sq,
                               use_kernel=False)
    torch.cuda.synchronize()
    tol = topk_tolerance(corpus, q, metric == "l2")[:, None]
    err = (ks - ps).abs()
    if not bool((err <= tol).all()):
        raise AssertionError(f"{label}: score error {float(err.max())} above "
                             f"bound {float(tol.max())}")
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


def compare_ivf(bucket_codes, bucket_ids, visit, luts, coarse, *, k, spp,
                lut_dtype, label) -> float:
    """ops.ivf_adc_topk on the kernel and on the plain version: the same
    float32 operations in the same order, so the bound is bit equality."""
    import torch
    from repro_torch.kernels import ops
    args = (bucket_codes, bucket_ids, visit, luts)
    kw = dict(k=k, coarse=coarse, steps_per_probe=spp, lut_dtype=lut_dtype)
    ks, ki = ops.ivf_adc_topk(*args, use_kernel=True, **kw)
    ps, pi = ops.ivf_adc_topk(*args, use_kernel=False, **kw)
    torch.cuda.synchronize()
    same_s = (ks == ps) | (torch.isneginf(ks) & torch.isneginf(ps))
    same_i = ki == pi.to(ki.dtype)
    finite = torch.isfinite(ks) & torch.isfinite(ps)
    err = float((ks - ps)[finite].abs().max()) if bool(finite.any()) else 0.0
    log(f"  {label}: ids agree {float(same_i.float().mean()):.4f} (bound 1), "
        f"max |dscore| {err:.3e} (bound 0, bit equality)")
    if not (bool(same_s.all()) and bool(same_i.all())):
        raise AssertionError(f"{label}: kernel and plain version differ")
    return err


def probe_inputs(index, q):
    """The ivf_adc kernel's inputs for queries q, as the engine builds them."""
    import torch
    from repro_torch.core import distances as D
    from repro_torch.core.pq import _ivf_probe_stage
    index._sync()
    metric = index.metric
    q = q.float()
    if metric == "cosine":
        q, metric = D.l2_normalize(q), "dot"
    visit, luts, coarse = _ivf_probe_stage(
        index.codebooks, index.centroids, q, index.block_table, metric=metric,
        nprobe=index.nprobe, steps_per_probe=index.spp,
        pad_block=index.bucket_ids.shape[0] - 1)
    return index.codes_bm, index.bucket_ids, visit, luts, coarse, index.spp


# -------------------------------------------------------------- phases
def phase_header() -> str:
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, "
        f"count {torch.cuda.device_count()}")
    return smi


def phase_build() -> None:
    from repro_torch.kernels import _build
    secs = _build.build_all(["topk_distance", "ivf_adc"])
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
    for metric in ("dot", "l2"):
        for k in (10, 200):
            for Q in BATCHES:
                compare_topk(corpus, queries[:Q], metric, k,
                             f"topk_distance {metric} k={k} Q={Q}")
    for metric in ("dot", "l2", "cosine"):
        db = VectorDB("ivf_pq", metric=metric, m=M_SUBSPACES,
                      device=device).load(corpus)
        for Q in BATCHES:
            codes, ids, visit, luts, coarse, spp = probe_inputs(db.index,
                                                                queries[:Q])
            for lut_dtype in ("float32", "bfloat16", "int8"):
                compare_ivf(codes, ids, visit, luts, coarse, k=32, spp=spp,
                            lut_dtype=lut_dtype,
                            label=f"ivf_adc {metric} {lut_dtype} Q={Q}")
        del db
    del corpus, queries
    torch.cuda.empty_cache()


def phase_main(n: int, seed: int, device, rank: int,
               min_recall: float) -> list:
    import torch
    from repro_torch import VectorDB
    from repro_torch.kernels import ops
    from repro_torch.kernels.ivf_adc import ivf_adc_cuda, ivf_adc_plain
    from repro_torch.kernels.topk_distance import (topk_distance_cuda,
                                                   topk_distance_plain)
    log(f"phase 4: main path, N={n} rows (MS MARCO v1 passages: "
        f"{MARCO_PASSAGES}), d={DIM}, cosine, shared subspace rank {rank}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    corpus, queries = make_dataset(n, max(BATCHES), seed, device, rank)
    torch.cuda.synchronize()
    log(f"  data made on the card: {time.perf_counter() - t0:.2f} s")
    kernels = []

    # --- flat: the exact ground truth
    t0 = time.perf_counter()
    flat = VectorDB("flat", metric="cosine", device=device).load(corpus)
    torch.cuda.synchronize()
    log(f"  flat load: {time.perf_counter() - t0:.2f} s")
    ops.reset_launch_counts()
    res = serve_batches(flat, queries, "flat")
    flat_launches = ops.launch_counts()
    log(f"  launches on the flat path: {flat_launches}")
    truth = res[max(BATCHES)][1]

    fc = flat.index.corpus
    q32 = queries[:32]
    bias = torch.zeros(fc.shape[0], dtype=torch.float32, device=device)
    for Q in BATCHES:
        ms = gpu_ms(lambda: topk_distance_cuda(fc, queries[:Q], bias, k=10,
                                               l2=False), 5)
        b, _ = bound_ms(fc.numel() * 4 + fc.shape[0] * 4 + Q * DIM * 4
                        + Q * 10 * 8, 2.0 * Q * fc.shape[0] * DIM)
        log(f"  topk_distance kernel Q={Q}: {ms:.3f} ms (bound {b:.3f} ms)")
    ms = gpu_ms(lambda: topk_distance_cuda(fc, q32, bias, k=10, l2=False), 5)
    plain_ms = gpu_ms(lambda: topk_distance_plain(fc, q32, bias, k=10,
                                                  l2=False), 2)
    lib_ms = gpu_ms(lambda: torch.topk(q32 @ fc.T, 10), 3)
    b, by = bound_ms(fc.numel() * 4 + fc.shape[0] * 4 + 32 * DIM * 4
                     + 32 * 10 * 8, 2.0 * 32 * fc.shape[0] * DIM)
    err = max(compare_topk(fc, queries[:Q], "dot", 10,
                           f"topk_distance full size Q={Q}") for Q in BATCHES)
    kernels.append({
        "name": "topk_distance", "route": "cuda",
        "source": "src/repro_torch/csrc/topk_distance.cu",
        "replaces": "src/repro/kernels/topk_distance.py:77",
        "launches": flat_launches["topk_distance"], "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
        "library_ms": lib_ms, "shape": f"Q=32 N={fc.shape[0]} d={DIM} k=10"})
    log(f"  topk_distance Q=32: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
        f"torch.matmul+torch.topk {lib_ms:.3f} ms, bound {b:.3f} ms ({by})")
    del flat, fc, bias, res
    torch.cuda.empty_cache()

    # --- ivf_pq: the engine under test
    t0 = time.perf_counter()
    db = VectorDB("ivf_pq", metric="cosine", m=M_SUBSPACES,
                  device=device).load(corpus)
    torch.cuda.synchronize()
    log(f"  ivf_pq load: {time.perf_counter() - t0:.2f} s "
        f"(clusters {db.index.centroids.shape[0]}, steps_per_probe "
        f"{db.index.spp}, storage rows {db.index.layout.capacity}, layout "
        f"{db.index.layout.memory_bytes() / 1e9:.3f} GB)")
    del corpus
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    res = serve_batches(db, queries, "ivf_pq")
    ivf_launches = ops.launch_counts()
    log(f"  launches on the ivf_pq path: {ivf_launches}")
    got = res[max(BATCHES)][1]
    recall = float(sum(len(set(got[r].tolist()) & set(truth[r].tolist()))
                       for r in range(got.shape[0])) / (10 * got.shape[0]))
    log(f"  recall@10 of ivf_pq against flat: {recall:.4f} "
        f"({got.shape[0]} queries)")

    idx = db.index
    blk, m = idx.block_size, idx.codebooks.shape[0]
    ivf_breakdown(idx, queries)
    for Q in BATCHES:
        codes, ids, visit, luts, coarse, spp = probe_inputs(idx, queries[:Q])
        ms = gpu_ms(lambda: ivf_adc_cuda(codes, ids, visit, luts, coarse,
                                         k=32, steps_per_probe=spp), 5)
        log(f"  ivf_adc kernel Q={Q}: {ms:.3f} ms (bound "
            f"{ivf_bound(ids, visit, luts, coarse, blk, m)[0]:.3f} ms)")
    codes, ids, visit, luts, coarse, spp = probe_inputs(idx, q32)
    ms = gpu_ms(lambda: ivf_adc_cuda(codes, ids, visit, luts, coarse, k=32,
                                     steps_per_probe=spp), 5)
    plain_ms = gpu_ms(lambda: ivf_adc_plain(codes, ids, visit, luts, coarse,
                                            k=32, steps_per_probe=spp), 2)
    b, by = ivf_bound(ids, visit, luts, coarse, blk, m)
    err = 0.0
    for Q in BATCHES[:2]:
        args = probe_inputs(idx, queries[:Q])
        err = max(err, compare_ivf(*args[:5], k=32, spp=args[5],
                                   lut_dtype="float32",
                                   label=f"ivf_adc full size Q={Q}"))
    kernels.append({
        "name": "ivf_adc", "route": "cuda",
        "source": "src/repro_torch/csrc/ivf_adc.cu",
        "replaces": "src/repro/kernels/ivf_adc.py:150",
        "launches": ivf_launches["ivf_adc"], "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
        "library_ms": None,
        "shape": f"Q=32 T={visit.shape[1]} blk={blk} m={m} k=32"})
    log(f"  ivf_adc Q=32: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
        f"bound {b:.3f} ms ({by}), no single library call")
    log(f"  peak device memory: {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    for name, count in (("topk_distance", flat_launches["topk_distance"]),
                        ("ivf_adc", ivf_launches["ivf_adc"])):
        if count <= 0:
            raise AssertionError(f"{name} never launched on the main path")
    if recall < min_recall:
        raise AssertionError(f"recall@10 {recall:.4f} below {min_recall}")
    return kernels


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
        visit, luts, coarse = _ivf_probe_stage(*args, **kw)
        scan = gpu_ms(lambda: ops.ivf_adc_topk(
            idx.codes_bm, idx.bucket_ids, visit, luts, k=idx.refine,
            coarse=coarse, steps_per_probe=idx.spp), 5)
        _, cand = ops.ivf_adc_topk(idx.codes_bm, idx.bucket_ids, visit, luts,
                                   k=idx.refine, coarse=coarse,
                                   steps_per_probe=idx.spp)
        rerank = gpu_ms(lambda: _exact_rerank(idx.corpus, idx.corpus_sq, cand,
                                              q, metric="dot", k=10), 5)
        log(f"  ivf_pq stages Q={Q}: probe stage {probe:.3f} ms, ivf_adc "
            f"{scan:.3f} ms, re-rank {rerank:.3f} ms (device ms, CUDA events)")


def ivf_bound(ids, visit, luts, coarse, blk: int, m: int,
              k: int = 32) -> tuple:
    """Least time for one ivf_adc call on these inputs: every distinct real
    block it visits read once (codes and slot ids), the tables, the (Q, T)
    visit table and (Q, nprobe) coarse terms read once, the (Q, k) result
    written once; m float32 adds a scored slot."""
    import torch
    pad = ids.shape[0] - 1
    real = int((torch.unique(visit) != pad).sum())
    slots = int((ids[visit.long()] >= 0).sum())
    Q, T = visit.shape
    n_bytes = (real * blk * (m + 4) + luts.numel() * 4 + Q * T * 4
               + coarse.numel() * 4 + Q * k * 8)
    return bound_ms(n_bytes, float(slots) * m)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=MARCO_PASSAGES,
                    help="corpus rows of the main phase")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rank", type=int, default=8,
                    help="rank of the subspace the centres share; 0 gives "
                         "unit centres plus isotropic noise")
    ap.add_argument("--min-recall", type=float, default=0.5,
                    help="fail below this recall@10 of ivf_pq against flat")
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
    smi = phase_header()
    phase_build()
    phase_mid(args.seed, device, args.rank)
    kernels = phase_main(args.n, args.seed, device, args.rank, args.min_recall)
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
