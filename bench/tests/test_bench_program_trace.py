"""The harness's reading of the program's spans (``harness.program_trace``):
the nested-interval lookup of idle gaps against a brute force, the numbers
of a hand-made drain, ``ProgramProfile`` over a few queries, and a whole
traced run on the CPU at a small size, where ``ProgramProfile`` in
``trace.Profile``'s place labels the idle gaps by program spans and gives
the span- and counter-based numbers of each cell."""
import random
import time

import numpy as np
import pytest
import torch

import run as bench_run
from cells import SEED, small
from harness import program_trace as pt
from harness import trace
from repro_torch import VectorDB
from repro_torch import trace as recorder

CPU = torch.device("cpu")
WANT = {"marco-ivfpq.uniform512": {"db.host_syncs", "engine.probe_host_ms",
                                   "engine.dispatch_host_ms",
                                   "engine.rerank_host_ms"},
        "marco-flat.clients32": {"db.host_syncs", "front.queue_wait_ms",
                                 "front.inflight_ms"}}


@pytest.mark.parametrize("name", sorted(WANT))
def test_a_traced_run_reads_the_program(name, monkeypatch):
    made = []

    class Recorded(pt.ProgramProfile):
        def __init__(self):
            super().__init__()
            made.append(self)

    monkeypatch.setattr(trace, "Profile", Recorded)
    res = bench_run.run(small(name), SEED, 2.0, True, CPU)
    assert res["correct"] is True
    (profile,) = made
    out = profile.summary()
    assert set(out["program"]) == WANT[name]
    if name.startswith("marco-flat"):
        assert out["program"]["db.host_syncs"] == 0
    # no kernel runs on the CPU: the window is one gap, inside the program
    (label,) = out["idle_gaps"]
    assert label != trace.OUTSIDE


def _brute(items, t):
    """The innermost (latest-starting, then shortest) interval open at t."""
    open_ = [x for x in items if x[0] <= t <= x[1]]
    if not open_:
        return None
    return max(open_, key=lambda x: (x[0], -x[1]))[2]


def _nested(rng, a, b, depth, out):
    """Random properly nested intervals inside [a, b]."""
    t = a
    while t < b and len(out) < 400:
        s = t + rng.randint(0, 20)
        e = s + rng.randint(0, 200)
        if e > b:
            break
        out.append((s, e, f"s{len(out)}"))
        if depth and e - s > 4:
            _nested(rng, s + 1, e - 1, depth - 1, out)
        t = e + rng.randint(1, 20)


@pytest.mark.parametrize("seed", range(4))
def test_intervals_match_brute_force(seed):
    rng = random.Random(seed)
    items = [(0, 10_000, "outer")]
    _nested(rng, 1, 9_999, 3, items)
    iv = pt.Intervals(items)
    for t in [rng.randint(-5, 10_010) for _ in range(500)]:
        assert iv.at(t) == _brute(items, t)


def test_a_long_span_behind_many_short_ones_still_labels():
    """A batch span behind more than 64 ended per-request spans on its
    thread: the gap after them is the batch span's."""
    items = [(0, 10_000, "front.fill")]
    items += [(10 + 20 * i, 20 + 20 * i, "front.queue") for i in range(200)]
    assert pt.Intervals(items).at(9_000) == "front.fill"
    assert pt.Intervals(items).at(15) == "front.queue"
    assert pt.Intervals(items).at(10_001) is None


def test_idle_gaps_and_numbers_from_program_spans():
    """``program_numbers`` over a hand-made drain: means of the stages, the
    counter over the calls, and a request's wait beside its batch's."""
    off = 1000
    spans = [("db.query", 0, 100, 5, -1, -1),
             ("ivf.probe", 10, 20, 5, 0, -1),
             ("ivf.dispatch", 20, 60, 5, 0, -1),
             ("ivf.rerank", 60, 90, 5, 0, -1),
             ("front.inflight", 200, 500, 0, -1, 3),
             ("front.queue", 150, 200, 0, 4, 3),
             ("front.queue", 100, 200, 0, 4, 4),
             ("db.query", 210, 0, 5, -1, -1)]     # never ended
    drained = {"spans": spans, "counters": {"host_syncs": 2}, "dropped": 0}
    got = pt.program_numbers(drained, off, 0, 10_000,
                             {"ivf.probe": 4e-6})
    assert got["db.host_syncs"] == 2.0
    assert got["engine.probe_host_ms"] == pytest.approx(1e-5)
    assert got["engine.dispatch_host_ms"] == pytest.approx(4e-5)
    assert got["engine.rerank_host_ms"] == pytest.approx(3e-5)
    assert got["engine.probe_device_ms"] == pytest.approx(4e-3)
    assert "engine.rerank_device_ms" not in got
    assert got["front.queue_wait_ms"] == pytest.approx(7.5e-5)
    assert got["front.inflight_ms"] == pytest.approx(3e-4)
    threads = pt.program_threads(pt._on_profiler_clock(drained, off))
    assert set(threads) == {5}
    assert threads[5].at(off + 30) == "ivf.dispatch"
    assert threads[5].at(off + 95) == "db.query"
    assert threads[5].at(off + 150) is None
    assert threads[5].at(off + 5000) == "db.query"   # open at the drain


def test_the_harness_profile_labels_gaps_by_program_spans():
    """``ProgramProfile`` on the CPU (no device activity: one gap, the
    window): the gap's midpoint inside a query lands on a program span, not
    on the harness's own ``db.query``."""
    g = torch.Generator().manual_seed(0)
    db = VectorDB("ivf_pq", device="cpu", n_clusters=24, m=8, ksub=64,
                  nprobe=4, refine=16, kmeans_iters=4)
    db.load(torch.randn(3000, 32, generator=g))
    q = torch.randn(64, 32, generator=g)
    p = pt.ProgramProfile()
    p.start()
    t_end = time.perf_counter() + 0.3
    spans = []
    while time.perf_counter() < t_end:
        t0 = time.perf_counter()
        db.query(q, k=5)
        spans.append((t0, time.perf_counter(), 64))
    p.stop()
    out = p.summary(spans)
    assert recorder.ON is False
    assert set(out["program"]) >= {"db.host_syncs", "engine.probe_host_ms",
                                   "engine.dispatch_host_ms",
                                   "engine.rerank_host_ms"}
    (label,) = out["idle_gaps"]
    assert label in pt.STAGES + ("db.query",)
    assert out["device_by_span"] == {} and out["launches_matched"] is None
    assert np.isfinite(out["clock_drift_ns"])
