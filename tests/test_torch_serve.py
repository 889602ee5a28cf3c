"""The port's serving fronts (``repro_torch.serve``) on the CPU.

The reference's async-front tests (tests/test_serve_async.py), each held
to the port's own ``bucketize=False`` oracle: oracle parity under
concurrent submitters, the async front against the synchronous pump with
interleaved writes, read-your-writes by queue order and across threads,
backpressure at the bound, shutdown with and without draining, restart,
the latency gauges and ``submit_many``. Then the pump's read-your-writes
(tests/test_mutation.py), a stream of reads and writes through the
reference's ``QueryEngine`` and the port's from one trained state (the
same ids and write results), the packed one-copy result transfer, and the
refusal of ``fsync_interval_ms`` without a write-ahead log.
"""
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro_torch import VectorDB  # noqa: E402
from repro_torch.serve import (AsyncQueryEngine, BackpressureError,  # noqa: E402
                               QueryEngine)
from repro_torch.serve.engine import (assemble_queries, bucket_of,  # noqa: E402
                                      pack_results, to_host, unpack_results,
                                      Request)


def _corpus(rng, n=400, d=32):
    return rng.normal(size=(n, d)).astype(np.float32)


def _db(engine="flat", metric="cosine", **kw):
    return VectorDB(engine, metric=metric, device="cpu", **kw)


# ------------------------------------------------------------ oracle parity
def test_concurrent_submitters_match_oracle(rng):
    corpus = _corpus(rng)
    db = _db().load(corpus)
    queries = corpus[:128] + 0.01 * rng.normal(size=(128, 32)).astype(np.float32)
    oracle_s, oracle_i = db.query(queries, k=5, bucketize=False)
    eng = AsyncQueryEngine(db, max_batch=16, max_wait_ms=1.0, max_queue=64)
    futs = [None] * 128

    def client(t):
        for j in range(32):
            i = t * 32 + j
            futs[i] = eng.submit(queries[i], k=5)

    threads = [threading.Thread(target=client, args=(t,)) for t in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert eng.drain(timeout=60)
    eng.close()
    for i, f in enumerate(futs):
        scores, ids = f.result(timeout=5)
        assert ids.shape == (5,)
        np.testing.assert_array_equal(ids, oracle_i[i])
        np.testing.assert_allclose(scores, oracle_s[i], atol=1e-5)


def _interleaved(submit, submit_write, new, qs):
    outs = []
    for i in range(40):
        if i % 10 == 3:
            submit_write("insert", new[(i // 10) * 6:(i // 10) * 6 + 6])
        if i % 10 == 7:
            submit_write("delete", ids=np.arange(i, i + 3))
        outs.append(submit(qs[i], 8))
    return outs


def test_async_matches_sync_pump_exactly(rng):
    corpus = _corpus(rng, n=256, d=16)
    kw = dict(n_clusters=8, nprobe=4, m=4, ksub=16, refine=0, block_size=8,
              seed=0)
    db_a = _db("ivf_pq", **kw).load(corpus)
    db_s = _db("ivf_pq", **kw).load(corpus)
    new = rng.normal(size=(24, 16)).astype(np.float32)
    qs = rng.normal(size=(40, 16)).astype(np.float32)
    eng_a = AsyncQueryEngine(db_a, max_batch=8, max_wait_ms=0.5)
    futs = _interleaved(lambda q, k: eng_a.submit(q, k),
                        lambda kind, *a, **k2: eng_a.submit_write(kind, *a, **k2),
                        new, qs)
    assert eng_a.drain(timeout=60)
    eng_a.close()
    eng_s = QueryEngine(db_s, max_batch=8, max_wait_ms=0.0)
    rids = _interleaved(lambda q, k: eng_s.submit(q, k),
                        lambda kind, *a, **k2: eng_s.submit_write(kind, *a, **k2),
                        new, qs)
    eng_s.drain()
    for f, rid in zip(futs, rids):
        s_a, i_a = f.result(timeout=5)
        s_s, i_s = eng_s.result(rid)
        np.testing.assert_array_equal(i_a, i_s)
        np.testing.assert_allclose(s_a, s_s, atol=1e-5)


# --------------------------------------------------------- read-your-writes
def test_read_your_writes_is_queue_order(rng):
    corpus = rng.normal(size=(16, 8)).astype(np.float32)
    target = np.full((8,), 2.0, np.float32)
    db = _db(metric="l2").load(corpus)
    eng = AsyncQueryEngine(db, max_batch=64, max_wait_ms=0.5, start=False)
    f_before = eng.submit(target, k=1)
    f_write = eng.submit_write("insert", target[None])
    f_after = eng.submit(target, k=1)
    eng.start()
    kind, new_ids = f_write.result(timeout=10)
    assert kind == "insert" and new_ids.tolist() == [16]
    assert int(f_before.result(timeout=10)[1][0]) != 16
    assert int(f_after.result(timeout=10)[1][0]) == 16
    eng.close()
    assert eng.latency_stats()["write_inserts"] == 1


def test_read_your_writes_across_threads(rng):
    corpus = rng.normal(size=(16, 8)).astype(np.float32)
    target = np.full((8,), 3.0, np.float32)
    db = _db(metric="l2").load(corpus)
    eng = AsyncQueryEngine(db, max_batch=8, max_wait_ms=0.5)
    got = {}

    def writer():
        got["write"] = eng.submit_write("insert", target[None]).result(10)

    def reader():
        wt = threading.Thread(target=writer)
        wt.start()
        wt.join()
        got["read"] = eng.submit(target, k=1).result(10)

    rt = threading.Thread(target=reader)
    rt.start()
    rt.join()
    eng.close()
    assert got["write"][1].tolist() == [16]
    assert int(got["read"][1][0]) == 16


def test_serve_read_your_writes_within_pump(rng):
    corpus = rng.normal(size=(16, 8)).astype(np.float32)
    target = np.full((8,), 2.0, np.float32)
    db = _db(metric="l2").load(corpus)
    eng = QueryEngine(db, max_batch=64, max_wait_ms=0.0)
    r_before = eng.submit(target, k=1)
    w = eng.submit_write("insert", target[None])
    r_after = eng.submit(target, k=1)
    assert eng.pump(force=True) == 1  # the read batch stops at the write
    eng.drain()
    kind, new_ids = eng.result(w)
    assert kind == "insert" and new_ids.tolist() == [16]
    assert int(eng.result(r_before)[1][0]) != 16
    assert int(eng.result(r_after)[1][0]) == 16
    assert eng.latency_stats()["write_inserts"] == 1
    eng.submit_write("delete", ids=new_ids)
    eng.submit_write("compact")
    eng.drain()
    st = eng.latency_stats()
    assert st["write_deletes"] == 1 and st["write_compactions"] == 1


# ------------------------------------------------------------- backpressure
def test_backpressure_rejects_at_bound(rng):
    corpus = _corpus(rng, n=64)
    db = _db().load(corpus)
    eng = AsyncQueryEngine(db, max_queue=4, overflow="reject", start=False)
    futs = [eng.submit(corpus[i], k=2) for i in range(4)]
    with pytest.raises(BackpressureError):
        eng.submit(corpus[4], k=2)
    with pytest.raises(BackpressureError):
        eng.submit_write("insert", corpus[:1])
    assert eng.rejected == 2
    eng.start()
    for f in futs:
        assert f.result(timeout=10)[1].shape == (2,)
    eng.close()
    st = eng.latency_stats()
    assert st["rejected"] == 2
    assert st["queue_depth_max"] == 4
    assert st["queue_depth"] == 0


def test_backpressure_block_times_out_then_frees(rng):
    corpus = _corpus(rng, n=64)
    db = _db().load(corpus)
    eng = AsyncQueryEngine(db, max_queue=2, overflow="block", start=False)
    futs = [eng.submit(corpus[i], k=2) for i in range(2)]
    with pytest.raises(BackpressureError):
        eng.submit(corpus[2], k=2, timeout=0.05)
    blocked = {}

    def late_submitter():
        blocked["fut"] = eng.submit(corpus[3], k=2)

    th = threading.Thread(target=late_submitter)
    th.start()
    time.sleep(0.05)
    assert th.is_alive()
    eng.start()
    th.join(timeout=10)
    assert not th.is_alive()
    for f in futs + [blocked["fut"]]:
        assert f.result(timeout=10)[1].shape == (2,)
    eng.close()
    assert eng.latency_stats()["rejected"] == 1


# ----------------------------------------------------------------- shutdown
def test_close_drains_cleanly_no_orphans(rng):
    corpus = _corpus(rng)
    db = _db().load(corpus)
    eng = AsyncQueryEngine(db, max_batch=8, max_wait_ms=0.5, max_queue=256)
    futs = [eng.submit(corpus[i % 400], k=3) for i in range(100)]
    futs.append(eng.submit_write("insert", corpus[:2]))
    eng.close(drain=True)
    assert all(f.done() for f in futs)
    for f in futs[:100]:
        assert f.result()[1].shape == (3,)
    kind, ids = futs[100].result()
    assert kind == "insert" and len(ids) == 2
    with pytest.raises(RuntimeError):
        eng.submit(corpus[0], k=3)


def test_close_without_drain_cancels_queued(rng):
    corpus = _corpus(rng, n=64)
    db = _db().load(corpus)
    eng = AsyncQueryEngine(db, max_queue=16, start=False)
    futs = [eng.submit(corpus[i], k=2) for i in range(5)]
    eng.close(drain=False)
    assert all(f.cancelled() for f in futs)
    assert eng.drain(timeout=5)


def test_close_without_drain_on_running_engine_leaves_no_pending(rng):
    corpus = _corpus(rng)
    db = _db().load(corpus)
    eng = AsyncQueryEngine(db, max_batch=4, max_wait_ms=0.0, max_queue=256)
    futs = [eng.submit(corpus[i % 400], k=2) for i in range(64)]
    eng.close(drain=False)
    assert eng.drain(timeout=30)
    for f in futs:
        assert f.done()
        if not f.cancelled():
            assert f.result()[1].shape == (2,)


def test_context_manager_and_restart(rng):
    corpus = _corpus(rng, n=64)
    db = _db().load(corpus)
    with AsyncQueryEngine(db, max_batch=4, max_wait_ms=0.0) as eng:
        f = eng.submit(corpus[1], k=1)
        assert int(f.result(timeout=10)[1][0]) == 1
    eng.start()
    f = eng.submit(corpus[2], k=1)
    assert int(f.result(timeout=10)[1][0]) == 2
    eng.close()


# -------------------------------------------------------------------- stats
def test_latency_stats_surface_gauges_and_counters(rng):
    corpus = _corpus(rng)
    db = _db().load(corpus)
    eng = AsyncQueryEngine(db, max_batch=8, max_wait_ms=0.5)
    assert eng.latency_stats() == {}
    futs = [eng.submit(corpus[i], k=3) for i in range(32)]
    eng.submit_write("insert", corpus[:1])
    assert eng.drain(timeout=60)
    eng.close()
    st = eng.latency_stats()
    assert st["n"] == 32
    assert np.isfinite(st["p50_ms"]) and np.isfinite(st["p99_ms"])
    assert st["p50_ms"] <= st["p99_ms"]
    assert st["plan_hits"] + st["plan_misses"] >= 1
    assert st["write_inserts"] == 1
    assert st["queue_depth"] == 0 and st["inflight"] == 0
    assert st["rejected"] == 0
    assert all(f.done() for f in futs)


def test_submit_many_matches_per_submit_path(rng):
    corpus = _corpus(rng, n=128, d=16)
    db = _db(metric="l2").load(corpus)
    queries = corpus[:48] + 0.01 * rng.normal(size=(48, 16)).astype(np.float32)
    oracle_i = db.query(queries, k=3, bucketize=False)[1].numpy()
    eng = AsyncQueryEngine(db, max_batch=16, max_queue=33, start=False)
    futs = eng.submit_many(queries[:32], k=3)
    assert len(futs) == 32 and eng.queue_depth_max == 32
    f_write = eng.submit_write("insert", corpus[:1])
    eng.start()
    assert f_write.result(timeout=10)[0] == "insert"
    futs += eng.submit_many(queries[32:], k=3)
    assert eng.drain(timeout=60)
    eng.close()
    got = np.stack([f.result(timeout=5)[1].numpy() for f in futs])
    np.testing.assert_array_equal(got, oracle_i)


def test_submit_many_backpressure_cancels_stranded_requests(rng):
    corpus = _corpus(rng, n=64, d=16)
    db = _db(metric="l2").load(corpus)
    eng = AsyncQueryEngine(db, max_queue=8, overflow="block", start=False)
    head = eng.submit_many(corpus[:8], k=2)
    with pytest.raises(BackpressureError):
        eng.submit_many(corpus[8:24], k=2, timeout=0.05)
    assert eng.rejected == 16
    eng.start()
    for f in head:
        assert f.result(timeout=10)[1].shape == (2,)
    assert eng.drain(timeout=30)
    eng.close()
    assert eng.latency_stats()["n"] == 8


# ------------------------------------------------------ the port's own parts
def test_write_errors_reach_the_future(rng):
    """A write the engine refuses resolves its future with the error; the
    front keeps serving."""
    corpus = _corpus(rng, n=32, d=8)
    db = _db().load(corpus)
    with AsyncQueryEngine(db, max_batch=4, max_wait_ms=0.0) as eng:
        bad = eng.submit_write("upsert", corpus[:1], ids=[999])
        with pytest.raises(ValueError, match="existing"):
            bad.result(timeout=10)
        assert int(eng.submit(corpus[3], k=1).result(timeout=10)[1][0]) == 3
    with pytest.raises(ValueError, match="write kind"):
        QueryEngine(db).submit_write("truncate")


def test_fsync_interval_needs_a_write_ahead_log(rng):
    db = _db().load(_corpus(rng, n=16, d=8))
    with pytest.raises(ValueError, match="write-ahead log"):
        AsyncQueryEngine(db, fsync_interval_ms=1.0, start=False)


def test_results_cross_to_the_host_in_one_packed_copy():
    scores = torch.tensor([[1.5, -torch.inf], [0.25, -2.0]])
    ids = torch.tensor([[7, -1], [3, 2**31 - 1]], dtype=torch.int32)
    s, i = unpack_results(pack_results(scores, ids))
    assert torch.equal(s, scores) and torch.equal(i, ids)
    assert i.dtype == torch.int32
    s, i = to_host(scores, ids)
    assert s is scores and i is ids  # on the CPU nothing is copied


def test_assemble_pads_to_the_bucket_with_the_last_query():
    reqs = [Request(j, np.full(4, j, np.float32)) for j in range(3)]
    q = assemble_queries(reqs, bucket_of(3))
    assert q.shape == (4, 4) and torch.equal(q[3], q[2])
    assert bucket_of(600) == 512


# --------------------------------------------------- against the reference
def test_pump_stream_matches_the_reference_pump():
    """One trained ivf_pq state in both packages, one stream of reads and
    writes (inserts, deletes with repeated ids, upserts, compact) through
    each package's QueryEngine: the same ids for every read and the same
    result for every write."""
    from repro.core import VectorDB as JaxVectorDB
    from repro_torch.core.convert import from_reference_state
    corpus, rng = _stream_corpus()
    kw = dict(n_clusters=8, nprobe=3, m=8, ksub=64, kmeans_iters=4,
              block_size=8)
    jdb = JaxVectorDB("ivf_pq", metric="l2", use_kernel=False,
                      adc_mode="per_query", **kw).load(corpus)
    state = {key: np.asarray(v) for key, v in jdb.index.state_dict().items()}
    db = VectorDB("ivf_pq", metric="l2", device="cpu", adc_mode="per_query",
                  **kw).load_state(from_reference_state(state))
    _pump_stream(jdb, db, corpus, rng)


def test_pump_stream_on_ivf_matches_the_reference_pump():
    """The same stream on the plain IVF engine, from the reference's
    trained state (its attributes: the engine has no state_dict)."""
    from repro.core import VectorDB as JaxVectorDB
    from repro_torch.core.convert import from_reference_state
    from test_torch_ivf import ivf_ref_state
    corpus, rng = _stream_corpus()
    kw = dict(n_clusters=8, nprobe=3, kmeans_iters=4)
    jdb = JaxVectorDB("ivf", metric="l2", **kw).load(corpus)
    db = VectorDB("ivf", metric="l2", device="cpu", **kw).load_state(
        from_reference_state(ivf_ref_state(jdb.index)))
    _pump_stream(jdb, db, corpus, rng)
    np.testing.assert_array_equal(db.index._buckets.numpy(),
                                  jdb.index._buckets)


def _stream_corpus():
    """500 clustered rows of d = 16, and the generator that made them (the
    stream's rows and queries come next from it)."""
    rng = np.random.default_rng(4)
    centers = rng.normal(size=(8, 16)).astype(np.float32) * 2.0
    return (centers[rng.integers(0, 8, 500)]
            + rng.normal(size=(500, 16)).astype(np.float32)) / np.float32(8), rng


def _pump_stream(jdb, db, corpus, rng):
    """One stream of reads and writes through each package's QueryEngine:
    the same ids for every read and the same result for every write."""
    from repro.serve import QueryEngine as JaxQueryEngine
    d = corpus.shape[1]
    new = corpus[rng.integers(0, 500, 60)] + 0.02 * rng.normal(
        size=(60, d)).astype(np.float32)
    qs = corpus[rng.integers(0, 500, 48)] + 0.05 * rng.normal(
        size=(48, d)).astype(np.float32)
    engines = (JaxQueryEngine(jdb, max_batch=8, max_wait_ms=0.0),
               QueryEngine(db, max_batch=8, max_wait_ms=0.0))
    rids = ([], [])
    for e, out in zip(engines, rids):
        for i in range(48):
            if i % 6 == 2:
                out.append(e.submit_write("insert", new[i:i + 6]))
            if i % 12 == 5:
                out.append(e.submit_write("delete", ids=np.array(
                    [i, i, i + 1, 9999])))
            if i % 16 == 9:
                out.append(e.submit_write("upsert", new[i:i + 2],
                                          ids=np.array([i + 100, i + 2])))
            if i == 30:
                out.append(e.submit_write("compact"))
            out.append(e.submit(qs[i], 10))
        e.drain()
    for rj, rt in zip(*rids):
        want, got = engines[0].result(rj), engines[1].result(rt)
        if isinstance(want[0], str):
            assert got[0] == want[0]
            if want[0] in ("insert", "upsert"):
                np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
            else:
                assert got[1] == want[1]
        else:
            np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
            np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                       atol=1e-5, rtol=1e-5)
    sj, st = engines[0].latency_stats(), engines[1].latency_stats()
    for key in ("n", "write_inserts", "write_deletes", "write_upserts",
                "write_compactions"):
        assert st[key] == sj[key], key
