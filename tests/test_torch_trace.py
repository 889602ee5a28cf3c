"""The span and counter recorder (``repro_torch.trace``) on the query path:
nothing recorded while off, the stage spans nested under ``db.query``, the
async front's request and batch spans sharing their ids, the host syncs of
one call counted, and a program span mapped onto the profiler's clock."""
import threading
import time

import pytest
import torch

from repro_torch import VectorDB
from repro_torch import trace
from repro_torch.core.ivf import ScheduleCache
from repro_torch.kernels import ops
from repro_torch.kernels.autotune import AutoTuner
from repro_torch.serve.async_engine import AsyncQueryEngine

torch.set_num_threads(2)
STAGES = ["ivf.probe", "ivf.dispatch", "ivf.rerank"]


@pytest.fixture
def recorder():
    """The recorder on over the test, then off and empty."""
    trace.enable()
    try:
        yield trace
    finally:
        trace.disable()
        trace.drain()


@pytest.fixture
def per_query_only(monkeypatch):
    """``auto`` serves the per-query grid with no tuner probe, as on the MS
    MARCO layout, where the grouped grids' board never fits."""
    monkeypatch.setattr(ops, "BLOCKED_MAX_BOARD_SLOTS", 0)


def _corpus(n=3000, d=32, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(n, d, generator=g)


def _db(engine, **kw):
    args = dict(n_clusters=24, m=8, ksub=64, nprobe=4, refine=16,
                kmeans_iters=4) if engine == "ivf_pq" else {}
    args.update(kw)
    db = VectorDB(engine, device="cpu", **args)
    db.load(_corpus())
    return db


@pytest.fixture(scope="module")
def ivfpq():
    return _db("ivf_pq")


@pytest.fixture(scope="module")
def flat():
    return _db("flat")


def _serve(db, n=40, **front):
    qs = _corpus(n, 32, seed=7)
    with AsyncQueryEngine(db, max_batch=8, max_wait_ms=0.5, **front) as eng:
        futs = [eng.submit(q, k=5) for q in qs]
        for f in futs:
            f.result(timeout=60)


@pytest.mark.parametrize("engine", ["ivfpq", "flat"])
def test_off_records_nothing(engine, request, per_query_only):
    db = request.getfixturevalue(engine)
    assert trace.ON is False
    db.query(_corpus(16, 32, seed=3), k=5)
    _serve(db)
    got = trace.drain()
    assert got["spans"] == [] and got["counters"] == {}
    assert got["dropped"] == 0


@pytest.mark.parametrize("rows", [1, 7, 64])
def test_stage_spans_nest_under_db_query(ivfpq, recorder, rows):
    ivfpq.query(_corpus(rows, 32, seed=rows), k=5)
    spans = trace.drain()["spans"]
    assert [s[0] for s in spans] == ["db.query"] + STAGES
    me = threading.get_native_id()
    q0, q1 = spans[0][1], spans[0][2]
    assert spans[0][4] == -1
    prev = q0
    for name, a, b, tid, parent, key in spans[1:]:
        assert parent == 0 and tid == me and key == -1
        assert prev <= a <= b <= q1
        prev = b


def test_nested_thread_and_parent_per_thread(ivfpq, recorder):
    """Two threads query in turn: each stage's parent is its own thread's
    ``db.query``."""
    lock = threading.Lock()

    def go():
        with lock:
            ivfpq.query(_corpus(4, 32, seed=9), k=5)

    ts = [threading.Thread(target=go) for _ in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in ts)
    spans = trace.drain()["spans"]
    assert len(spans) == 8
    for i, s in enumerate(spans):
        if s[0] == "db.query":
            continue
        p = spans[s[4]]
        assert p[0] == "db.query" and p[3] == s[3]
        assert p[1] <= s[1] <= s[2] <= p[2]
    assert len({s[3] for s in spans}) == 2


def test_front_queue_and_inflight_share_ids(flat, recorder):
    n = 40
    _serve(flat, n=n)
    spans = trace.drain()["spans"]
    queue = [s for s in spans if s[0] == "front.queue"]
    assert sorted(s[5] for s in queue) == list(range(n))
    dispatch = {s[5]: s for s in spans if s[0] == "front.dispatch"}
    batcher = {s[3] for s in dispatch.values()}
    assert len(batcher) == 1
    for name, a, b, tid, parent, key in queue:
        inf = spans[parent]
        assert inf[0] == "front.inflight" and tid == 0 and inf[3] == 0
        assert a <= b == inf[1] <= inf[2]
        # the batch id is the rid of its first request, on every batch span
        assert inf[5] <= key and inf[5] in dispatch
    per_batch = {}
    for s in queue:
        per_batch.setdefault(spans[s[4]][5], []).append(s[5])
    assert all(min(v) == k for k, v in per_batch.items())
    # the batcher's spans: db.query inside front.dispatch, in turn with the
    # slot wait and the fill of the same batch
    for s in spans:
        if s[0] == "db.query":
            assert s[3] in batcher and spans[s[4]][0] == "front.dispatch"
    for bid in dispatch:
        names = [s[0] for s in spans if s[5] == bid and s[3] in batcher]
        assert names == ["front.slot_wait", "front.fill", "front.dispatch"]


def test_host_syncs_of_one_call(ivfpq, flat, recorder, per_query_only):
    """Where no grouped grid's board fits, ``auto`` on IVF-PQ counts the
    sharing on the device and reads nothing on the host; nor does the
    exact engine."""
    q = _corpus(32, 32, seed=11)
    ivfpq.query(q, k=5)          # the plan and its tuner key settle
    trace.drain()
    ivfpq.query(q, k=5)
    got = trace.drain()
    assert got["counters"] == {}
    st = ivfpq.index.adc_stats
    assert st["per_query"] > 0 and st["sharing_deferred"] > 0
    flat.query(q, k=5)
    got = trace.drain()
    assert got["counters"] == {} and len(got["spans"]) == 1


class _SettledPerQuery(AutoTuner):
    """A tuner whose every key is fitted with a crossover no batch clears:
    ``auto`` weighs the grouped grids and serves the per-query one."""

    def lookup(self, key):
        return {"grouped_mode": "blocked", "qblk": 8,
                "crossover": float("inf")}


def test_host_syncs_of_one_call_where_the_board_fits(recorder, monkeypatch):
    """Where the board fits, ``auto`` reads the sharing probe's mask and
    ``unique`` on the host to weigh the grouped grids."""
    monkeypatch.setattr(ops, "LEDGER", _SettledPerQuery())
    db = _db("ivf_pq")
    q = _corpus(32, 32, seed=11)
    db.query(q, k=5)
    trace.drain()
    db.query(q, k=5)
    assert trace.drain()["counters"] == {"host_syncs": 2}
    st = db.index.adc_stats
    assert st["per_query"] == 2 and st["sharing_deferred"] == 0


def test_host_syncs_per_query_mode_is_zero(recorder):
    db = _db("ivf_pq", adc_mode="per_query")
    trace.drain()
    db.query(_corpus(8, 32, seed=12), k=5)
    got = trace.drain()
    assert got["counters"] == {}
    assert [s[0] for s in got["spans"]] == ["db.query"] + STAGES


def test_a_schedule_lookup_counts_a_sync_only_when_it_compares(recorder):
    """``ScheduleCache.get`` reads the device on the host only when an
    entry of the same shape is there to compare with; ``_synchronize``
    only on the card."""
    cache = ScheduleCache()
    visit = torch.arange(12).reshape(3, 4)
    assert cache.get("k", visit) is None
    cache.put("k", torch.arange(8).reshape(2, 4), "built")
    assert cache.get("k", visit) is None
    ops._synchronize(visit)
    assert trace.drain()["counters"] == {}
    cache.put("k", visit.clone(), "built")
    assert cache.get("k", visit) == "built"
    assert cache.get("k", visit + 1) is None
    assert trace.drain()["counters"] == {"host_syncs": 2}


def test_cap_drops_and_counts(monkeypatch):
    monkeypatch.setattr(trace, "DEFAULT_CAP", 3)
    trace.enable()
    try:
        for i in range(5):
            sp = trace.begin("x", key=i)
            trace.end(sp)
        got = trace.drain()
    finally:
        trace.disable()
        trace.drain()
    assert [s[5] for s in got["spans"]] == [0, 1, 2]
    assert got["dropped"] == 2
    assert all(s[2] >= s[1] > 0 for s in got["spans"])


def test_stale_token_after_drain_is_ignored(recorder):
    sp = trace.begin("late")
    trace.drain()
    trace.end(sp)
    inner = trace.begin("fresh")
    trace.end(inner)
    got = trace.drain()["spans"]
    assert [(s[0], s[4]) for s in got] == [("fresh", -1)]


def test_exception_inside_a_span_leaves_no_stale_parent(ivfpq, recorder):
    with pytest.raises(RuntimeError):
        VectorDB("flat", device="cpu").query(torch.zeros(2, 8))
    ivfpq.query(_corpus(2, 32, seed=1), k=5)
    spans = trace.drain()["spans"]
    assert [(s[0], s[4]) for s in spans[:2]] == [("db.query", -1),
                                                 ("db.query", -1)]


def test_a_program_span_lies_on_the_profiler_clock():
    """A ``record_function`` block inside a program span, under a CPU
    profiler: mapped with ``profiler_clock_offset`` (the offset the
    benchmark's harness takes), the span holds the block to within
    100 us."""
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        off = trace.profiler_clock_offset()
        trace.enable()
        try:
            sp = trace.begin("db.query")
            time.sleep(0.002)
            with record_function("inside"):
                x = torch.randn(64, 64)
                (x @ x).sum()
            time.sleep(0.002)
            trace.end(sp)
        finally:
            trace.disable()
        drift = trace.profiler_clock_offset() - off
        got = trace.drain()
    (name, a, b, _, _, _), = got["spans"]
    a, b = a + off, b + off
    blocks = [e for e in prof.profiler.kineto_results.events()
              if e.name() == "inside"]
    assert len(blocks) == 1
    e = blocks[0]
    slack = 100_000
    assert a - slack <= e.start_ns()
    assert e.start_ns() + e.duration_ns() <= b + slack
    assert b - a >= 4_000_000          # the span is not the block itself
    assert abs(drift) < 1_000_000
