#!/usr/bin/env python3
"""Time ivf_pq's ADC dispatch end to end on one GPU.

    python3 tools/ivf_dispatch.py [--src DIR] [--label L] [--n ROWS] [--seed S]
                                  [--device cuda|cpu]

Loads ``VectorDB("ivf_pq")`` (cosine, m = 64) over chip_smoke's clustered
synthetic corpus (N = 8,841,823 rows, d = 768, made on the card from
``--seed``) and serves ``db.query(q, k=10)`` under adc_mode auto,
per_query, blocked and run_resident at Q = 1, 32, 512, on two kinds of
traffic:

  * repeated: one batch of Q queries served again and again, as
    chip_smoke's ``serve_batches`` does, so the schedule cache hits;
  * distinct: every batch new (each mode its own queries), so the
    grouped grids build their schedule (and pair index) every time.

The autotuner is reset before each kind of traffic and auto is served
first, so its probes run on that traffic, at Q = 1, as in chip_smoke. The
first batches at each Q are warm-up (auto's probes among them). For each
(traffic, mode, Q) it prints the p50 and p99 host-clock ms of a call
ending in a synchronize and the grids the timed batches were served by,
then auto's fitted decisions, and, as its last line, one JSON object of
all of it.

``--src`` names the ``src/`` directory whose ``repro_torch`` is timed (by
default this checkout's), so that two trees can be compared on one card
in one call, each in its own process. The data comes from chip_smoke.py
beside this directory. ``--device cpu`` runs the same steps on the plain
versions (a rehearsal at a small ``--n``; its times mean nothing).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
BATCHES = (1, 32, 512)
WARM = {1: 12, 32: 2, 512: 2}      # 12 at Q = 1 covers auto's 10 probes
REPS = {1: 40, 32: 20, 512: 8}
MODES = ("auto", "per_query", "blocked", "run_resident")


def queries_a_mode() -> int:
    return sum((WARM[Q] + REPS[Q]) * Q for Q in BATCHES)


def served(db) -> dict:
    st = db.adc_stats or {}
    return {g: st.get(g, 0) for g in ("per_query", "blocked", "run_resident")}


def sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(db, pool, Q: int, distinct: bool) -> dict:
    """WARM[Q] then REPS[Q] batches of Q queries from ``pool``: the same
    first Q every time, or the next Q each batch. Returns p50, p99 (ms)
    and the grids that served the timed batches."""
    import torch
    at = 0

    def batch():
        nonlocal at
        q = pool[at:at + Q]
        if distinct:
            at += Q
        return q

    for _ in range(WARM[Q]):
        db.query(batch(), k=10)
    sync(pool.device)
    before = served(db)
    times = []
    for _ in range(REPS[Q]):
        q = batch()
        t0 = time.perf_counter()
        s, _ = db.query(q, k=10)
        sync(pool.device)
        times.append(time.perf_counter() - t0)
        if not (s.shape == (Q, 10) and torch.isfinite(s[:, 0]).all()):
            raise AssertionError(f"Q={Q}: bad result {tuple(s.shape)}")
    after = served(db)
    times.sort()
    return {"p50": times[(len(times) - 1) // 2] * 1e3,
            "p99": times[min(len(times) - 1,
                             int(0.99 * len(times)))] * 1e3,
            "served": {g: after[g] - before[g] for g in after
                       if after[g] > before[g]}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--n", type=int, default=8_841_823)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import torch
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("ivf_dispatch: no CUDA card", file=sys.stderr)
        return 1
    import chip_smoke
    from repro_torch import VectorDB
    from repro_torch.kernels import _build
    from repro_torch.kernels.autotune import LEDGER
    card = "cpu"
    if dev.type == "cuda":
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True).stdout.strip().splitlines()[0]
        _build.build_all(["topk_distance", "pq_adc", "ivf_adc"])
    print(f"{args.label}: repro_torch from {args.src}; {card}", flush=True)
    per_mode = queries_a_mode()
    corpus, pool = chip_smoke.make_dataset(args.n, len(MODES) * per_mode,
                                           args.seed, dev)
    t0 = time.perf_counter()
    db = VectorDB("ivf_pq", metric="cosine", m=chip_smoke.M_SUBSPACES,
                  device=dev).load(corpus)
    sync(dev)
    print(f"  ivf_pq load {time.perf_counter() - t0:.2f} s", flush=True)
    out = {"label": args.label, "card": card, "traffic": {},
           "decisions": {}}
    for traffic in ("repeated", "distinct"):
        LEDGER.reset()
        res = out["traffic"][traffic] = {}
        for j, mode in enumerate(MODES):
            db.index.adc_mode = mode
            mine = pool[j * per_mode:(j + 1) * per_mode]
            res[mode] = {}
            at = 0
            for Q in BATCHES:
                n = (WARM[Q] + REPS[Q]) * Q
                r = serve(db, mine[at:at + n], Q, traffic == "distinct")
                at += n
                res[mode][str(Q)] = r
                print(f"  {args.label} {traffic} {mode} Q={Q}: p50 "
                      f"{r['p50']:.3f} ms, p99 {r['p99']:.3f} ms "
                      f"(n={REPS[Q]}), served by {r['served']}",
                      flush=True)
        out["decisions"][traffic] = LEDGER.decisions()
        print(f"  {args.label} {traffic}: auto's decisions "
              f"{out['decisions'][traffic]}", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
