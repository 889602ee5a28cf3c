#!/usr/bin/env python3
"""Run one cell of the benchmark with the program's span recorder
(``repro_torch.trace``) and print what its spans and counters show.

    python3 tools/trace_cell.py --workload <cell> --seed <n> [--seconds 5]
                                [--cost-windows 3] [--cost-seconds 20]
                                [--device cpu --small]

This is ``bench/run.py``'s traced run (``run``: set-up, the traced window,
the per-layer metrics, the reference's judgement) with two substitutions:
``ProgramProfile`` (``bench/harness/program_trace.py``) in
``harness.trace.Profile``'s place, so the recorder is on over the traced
window, and the traffic's driver made to do three things more inside the
run, on the system it set up:

1. before the traced window, ``--cost-windows`` pairs of windows of
   ``--cost-seconds`` with the profiler off and the recorder off and on in
   turns (off, on, on, off, ...): qps and p50 of each, as the benchmark's
   ``--trace 0`` reads them, and the spans each on-window recorded: what
   the recorder costs when on;
2. ``ARM_SECONDS`` of traffic with the recorder armed
   (``ProgramProfile.arm``), so that a wait the front is in as the traced
   window opens is on record;
3. after the traced window, with the driver closed and its threads joined,
   ``SYNC_CALLS`` ``db.query`` calls of a traffic-sized batch under
   ``torch.cuda.set_sync_debug_mode("warn")`` with the recorder on: for
   each call the synchronizing operations the card reports (the line that
   made each, and its thread) beside the ``host_syncs`` the program
   counted (the card only).

The last line of standard output is one JSON object: ``bench/run.py``'s
result, and beside it the cost windows, the traced window's mean request
latency, the program's numbers, the idle gaps and the host thread's time
by program span, the device time by the span that launched it, and the
sync check. ``--device cpu --small`` runs it at the benchmark's CPU test
size (``bench/tests/cells.py``; its times mean nothing).
"""
from __future__ import annotations

import argparse
import json
import sys
import threading
import time
import warnings
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "bench"), str(ROOT / "src")]

import run as bench_run  # noqa: E402

SYNC_CALLS = 3
ARM_SECONDS = 1.0


def _window_numbers(rec, seconds: float) -> dict:
    lat = rec.latency_array()
    return {"qps": rec.completed_in_window / seconds,
            "p50_ms": float(np.percentile(lat, 50)) if len(lat) else None,
            "mean_ms": float(lat.mean()) if len(lat) else None}


def cost_windows(window, n: int, seconds: float) -> list:
    """``n`` pairs of ``window(seconds)``, recorder off and on in turns."""
    from repro_torch import trace as recorder
    out = []
    for i in range(2 * n):
        on = (i % 4) in (1, 2)
        if on:
            recorder.enable()
        rec = window(seconds)
        recorder.disable()
        spans = recorder.drain() if on else None
        row = dict(_window_numbers(rec, seconds), recorder=on)
        if on:
            row["spans"] = len(spans["spans"])
            row["dropped"] = spans["dropped"]
        bench_run.log(f"window {i}: {row}")
        out.append(row)
    return out


def sync_check(db, q, k: int) -> list:
    """``SYNC_CALLS`` calls of ``db.query(q)`` under the card's sync debug
    mode, one row each: the synchronizing operations it warned of (message,
    the Python line that made it, the thread) and the program's
    ``host_syncs`` for the same call."""
    import torch
    from repro_torch import trace as recorder
    out = []
    for _ in range(SYNC_CALLS):
        torch.cuda.synchronize()
        caught = []

        def show(message, category, filename, lineno, file=None, line=None):
            if "called a synchronizing" in str(message):
                caught.append({"where": f"{filename}:{lineno}",
                               "thread": threading.current_thread().name,
                               "message": str(message)[:80]})

        recorder.enable()
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = show
            torch.cuda.set_sync_debug_mode("warn")
            try:
                db.query(q, k=k)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        recorder.disable()
        counted = recorder.drain()["counters"].get("host_syncs", 0)
        torch.cuda.synchronize()
        out.append({"rows": int(q.shape[0]), "host_syncs": counted,
                    "sync_debug_warnings": len(caught), "warned": caught})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=bench_run.TRACE_SECONDS)
    ap.add_argument("--cost-windows", type=int, default=0)
    ap.add_argument("--cost-seconds", type=float, default=20.0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--small", action="store_true")
    args = ap.parse_args(argv)

    import torch
    from harness import manifest
    from harness import trace as tr
    from harness.program_trace import ProgramProfile
    if args.small:
        sys.path.insert(0, str(ROOT / "bench" / "tests"))
        from cells import small
        cell = small(args.workload)
    else:
        cell = manifest.cell(args.workload)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("needs a CUDA card (or --device cpu)", file=sys.stderr)
        return 2
    device = torch.device(args.device, 0 if args.device == "cuda" else None)
    traffic = cell.traffic
    found = {}

    class Recorded(ProgramProfile):
        def summary(self, spans=()):
            found["summary"] = super().summary(spans)
            return found["summary"]

    base = manifest.driver(traffic["driver"])

    class Tooled(base):
        def window(self, entry, seconds, profile=None):
            found["cost"] = cost_windows(
                lambda s: base.window(self, entry, s), args.cost_windows,
                args.cost_seconds)
            # the recorder on over a short stretch of traffic first, so
            # that the async front's batcher is in a recorded wait as the
            # traced window opens
            profile.arm()
            base.window(self, entry, ARM_SECONDS)
            rec = base.window(self, entry, seconds, profile)
            found["window"] = _window_numbers(rec, seconds)
            self.close()
            if device.type == "cuda":
                pool = (self.pool if hasattr(self, "pool")
                        else self.host_pool.to(device))
                rows = int(traffic.get("block", traffic.get("clients", 1)))
                found["sync_check"] = sync_check(entry, pool[:rows],
                                                 int(traffic["k"]))
            return rec

    tr.Profile = Recorded
    manifest.driver = lambda name: Tooled
    result = bench_run.run(cell, args.seed, args.seconds, True, device)
    summary = found["summary"]
    out = {"workload": cell.name, "seed": args.seed, "result": result,
           "cost": found["cost"], "traced": found["window"],
           "program": summary["program"],
           "host_s": tr.top(summary["host_s"]),
           "device_by_span": tr.top(summary["device_by_span"]),
           "clock_drift_ns": summary["clock_drift_ns"],
           "dropped": summary["dropped"],
           "launches_matched": summary["launches_matched"],
           "sync_check": found.get("sync_check")}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    t = time.perf_counter()
    rc = main()
    bench_run.log(f"done in {time.perf_counter() - t:.1f} s")
    sys.exit(rc)
