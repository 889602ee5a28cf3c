"""The port's grouped IVF-ADC grids, block schedule, autotuner and dispatch
against the JAX package, on the CPU.

``build_block_schedule`` and ``visit_sharing`` return the reference's
arrays exactly. The blocked and run-resident plain versions (what the
wrappers run on a CPU tensor) equal the port's per-query plain version bit
for bit (invariant 5 of docs/ARCHITECTURE.md) and the reference's jnp
twins. They are not held against the reference's float32 Pallas grouped
grids, which miss bit parity in interpret mode on the installed jax
(ROADMAP.md Queue 3). The ``ivf_pq`` engine under every ``adc_mode`` and
with adaptive probing, loaded from the reference's trained state, answers
as the reference's engine does: ids exact but for near-ties, scores
within atol = rtol = 1e-5.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from repro.core import VectorDB as JaxVectorDB  # noqa: E402
from repro.core import build_block_lists as jax_build_block_lists  # noqa: E402
from repro.core import ivf as jivf  # noqa: E402
from repro.kernels import autotune as jtune  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch import VectorDB  # noqa: E402
from repro_torch.core import ivf as tivf  # noqa: E402
from repro_torch.core.convert import from_reference_state  # noqa: E402
from repro_torch.kernels import autotune as ttune  # noqa: E402
from repro_torch.kernels import ivf_adc as tadc  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import visit_sharing as tvs  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
NEG_INF = -1e30
GROUPED = ("blocked", "run_resident")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ------------------------------------------------------------- schedule
def _visit(rng, Q, T, B, pad_share):
    visit = rng.integers(0, B - 1, (Q, T)).astype(np.int32)
    visit[rng.random((Q, T)) < pad_share] = B - 1
    return visit


@pytest.mark.parametrize("pad", [True, False])
@pytest.mark.parametrize("case", [
    dict(Q=37, T=12, B=50, qblk=8, pad_share=0.3),
    dict(Q=5, T=40, B=9, qblk=4, pad_share=0.5),      # heavy sharing
    dict(Q=64, T=3, B=400, qblk=16, pad_share=0.1),   # little sharing
    dict(Q=300, T=16, B=30, qblk=1, pad_share=0.2),   # G past the ladder
    dict(Q=6, T=4, B=7, qblk=8, pad_share=1.0),       # pad pairs only
    dict(Q=0, T=4, B=7, qblk=8, pad_share=0.0),       # empty table
])
def test_block_schedule_matches_reference(rng, case, pad):
    case = dict(case)
    qblk = case.pop("qblk")
    visit = _visit(rng, **case)
    pad_block = case["B"] - 1 if pad else None
    got = tivf.build_block_schedule(_t(visit), qblk=qblk, pad_block=pad_block)
    want = jivf.build_block_schedule(visit, qblk=qblk, pad_block=pad_block)
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(_np(g), w)
    gs, ws = got[3], want[3]
    for key in ("pairs", "blocks", "sharing", "groups", "n_runs"):
        assert gs[key] == ws[key], key
    for g, w in zip(gs["runs"], ws["runs"]):
        np.testing.assert_array_equal(_np(g), w)
    np.testing.assert_array_equal(_np(gs["grun"]), ws["grun"])
    assert tivf.visit_sharing(_t(visit), pad_block=pad_block) == \
        jivf.visit_sharing(visit, pad_block=pad_block)


SHARING_CASES = {
    "repeats, pad block": (dict(Q=37, T=12, B=50, pad_share=0.3), True),
    "repeats, no pad block": (dict(Q=37, T=12, B=50, pad_share=0.3), False),
    "heavy repeats": (dict(Q=64, T=16, B=6, pad_share=0.1), True),
    "all pad": (dict(Q=6, T=4, B=7, pad_share=1.0), True),
    "no pad in the table": (dict(Q=20, T=8, B=40, pad_share=0.0), True),
    "empty table": (dict(Q=0, T=4, B=7, pad_share=0.0), True),
}


@pytest.mark.parametrize("name", sorted(SHARING_CASES))
def test_visit_sharing_device_matches_the_host_probe(rng, name):
    """The sync-free count gives ``visit_sharing``'s pairs, blocks and
    sharing exactly, as 0-dim int64, int64 and float64 tensors, and the
    reference's host count gives the same numbers."""
    case, pad = SHARING_CASES[name]
    visit_np = _visit(rng, **case)
    visit = _t(visit_np)
    pad_block = case["B"] - 1 if pad else None
    got = tvs.visit_sharing_device(visit, case["B"], pad_block=pad_block)
    assert [(v.dim(), v.dtype) for v in got.values()] == \
        [(0, torch.int64), (0, torch.int64), (0, torch.float64)]
    got = {key: v.item() for key, v in got.items()}
    assert got == tivf.visit_sharing(visit, pad_block=pad_block)
    assert got == jivf.visit_sharing(visit_np, pad_block=pad_block)


def test_schedule_cache_checks_the_visit_table(rng):
    cache = tivf.ScheduleCache(cap=2)
    visit = _t(_visit(rng, 8, 6, 20, 0.2))
    built = ops._build_schedule_cached(visit, 8, 19, cache, ("b",), 8, 6)
    assert ops._build_schedule_cached(visit.clone(), 8, 19, cache, ("b",),
                                      8, 6) is built
    changed = visit.clone()
    changed[0, 0] = (changed[0, 0] + 1) % 19
    again = ops._build_schedule_cached(changed, 8, 19, cache, ("b",), 8, 6)
    assert again is not built
    assert cache.stats == {"hits": 1, "misses": 2}
    for key in ("c", "d"):  # least recently used goes first
        ops._build_schedule_cached(visit, 8, 19, cache, (key,), 8, 6)
    assert ops._build_schedule_cached(changed, 8, 19, cache, ("b",), 8,
                                      6) is not again


# ----------------------------------------------------- grouped plain grids
def _problem(rng, *, per_probe, N=600, C=15, blk=8, Q=40, nprobe=5, m=8,
             ksub=32, tombstones=0.1):
    """Ragged clusters over block lists, -1 slots, a knocked-out probe;
    m = 8 subspaces over 32 codewords keep scores tie-free."""
    assign = rng.integers(0, C, N)
    slots, bstart, bcnt, spp = jax_build_block_lists(assign, C, blk=blk)
    slots = np.array(slots)
    slots[(rng.random(slots.shape) < tombstones) & (slots >= 0)] = -1
    codes = rng.integers(0, ksub, (slots.shape[0], blk, m)).astype(np.uint8)
    probe = np.stack([rng.choice(C, nprobe, replace=False) for _ in range(Q)])
    base, cnt = np.asarray(bstart)[probe], np.asarray(bcnt)[probe]
    r = np.arange(spp)[None, None, :]
    visit = np.where(r < cnt[:, :, None], base[:, :, None] + r,
                     slots.shape[0] - 1).reshape(Q, -1).astype(np.int32)
    lshape = (Q, nprobe, m, ksub) if per_probe else (Q, m, ksub)
    luts = rng.normal(size=lshape).astype(np.float32)
    coarse = rng.normal(size=(Q, nprobe)).astype(np.float32)
    coarse[0, 1] = NEG_INF
    return codes, slots, visit, luts, coarse, spp


def _jax_twin(mode, codes, slots, visit, luts, coarse, sched, k, spp,
              lut_dtype):
    sb, sq, st, s2 = sched
    args = dict(k=k, steps_per_probe=spp, lut_dtype=lut_dtype)
    c, ids = jnp.asarray(codes.astype(np.int32)), jnp.asarray(slots)
    if mode == "blocked":
        return jops.ivf_adc_blocked_jnp(
            c, ids, jnp.asarray(sb), jnp.asarray(sq), jnp.asarray(st),
            jnp.asarray(luts), jnp.asarray(coarse), **args)
    return jops.ivf_adc_run_resident_jnp(
        c, ids, jnp.asarray(s2["runs"][0]), jnp.asarray(s2["grun"]),
        jnp.asarray(sq), jnp.asarray(st), jnp.asarray(visit),
        jnp.asarray(luts), jnp.asarray(coarse), **args)


@pytest.mark.parametrize("qblk", [4, 8])
@pytest.mark.parametrize("lut_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("per_probe", [False, True])
@pytest.mark.parametrize("mode", GROUPED)
def test_grouped_plain_matches_twin_and_per_query(rng, mode, per_probe,
                                                  lut_dtype, qblk):
    """Bit for bit against the port's per-query plain version, and against
    the reference's twin on the reference's own schedule."""
    codes, slots, visit, luts, coarse, spp = _problem(rng,
                                                      per_probe=per_probe)
    pad_block = slots.shape[0] - 1
    sched = ops.build_schedule(_t(visit), qblk=qblk, pad_block=pad_block)
    fn = (tadc.ivf_adc_blocked_plain if mode == "blocked"
          else tadc.ivf_adc_run_resident_plain)
    args = (_t(codes), _t(slots), _t(visit))
    kw = dict(k=30, steps_per_probe=spp, lut_dtype=lut_dtype)
    gs, gi = fn(*args, sched, _t(luts), _t(coarse), **kw)
    ps, pi = tadc.ivf_adc_plain(*args, _t(luts), _t(coarse), **kw)
    gs, gi = ops.normalize_knockouts(gs, gi)
    ps, pi = ops.normalize_knockouts(ps, pi)
    assert torch.equal(gi, pi) and torch.equal(gs, ps)
    js, ji = _jax_twin(mode, codes, slots, visit, luts, coarse,
                       jivf.build_block_schedule(visit, qblk=qblk,
                                                 pad_block=pad_block),
                       30, spp, lut_dtype)
    bad = js <= 0.5 * NEG_INF
    js, ji = jnp.where(bad, -jnp.inf, js), jnp.where(bad, -1, ji)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ji))
    if lut_dtype == "int8":
        # XLA's compiled twin does not round each int8 term's product
        # before adding it (its sums differ from multiply-then-add in the
        # last bit), so against it the float32 tolerance holds
        np.testing.assert_allclose(gs.numpy(), np.asarray(js), **TOL)
    else:
        np.testing.assert_array_equal(gs.numpy(), np.asarray(js))


@pytest.mark.parametrize("mode", ["auto", "per_query"] + list(GROUPED))
def test_ivf_adc_topk_modes_match_reference(rng, mode):
    """ops.ivf_adc_topk in every mode against the reference's dispatcher
    on its jnp twins: ids equal, scores within 1e-5, and the same stats."""
    codes, slots, visit, luts, coarse, spp = _problem(rng, per_probe=True)
    pad_block = slots.shape[0] - 1
    kw = dict(k=25, steps_per_probe=spp, mode=mode, pad_block=pad_block)
    tstats, jstats = {}, {}
    ts, ti = ops.ivf_adc_topk(_t(codes), _t(slots), _t(visit), _t(luts),
                              coarse=_t(coarse), stats=tstats,
                              autotune=ttune.AutoTuner(), **kw)
    js, ji = jops.ivf_adc_topk(jnp.asarray(codes.astype(np.int32)),
                               jnp.asarray(slots), jnp.asarray(visit),
                               jnp.asarray(luts), coarse=jnp.asarray(coarse),
                               use_kernel=False, stats=jstats,
                               autotune=jtune.AutoTuner(), **kw)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)
    assert tstats == jstats


# ------------------------------------------------------------ autotuner
_RECORDINGS = {
    "grouped wins": [(("per_query", 0), 3.0, 0.010), (("per_query", 0), 3.1, 0.011),
                     (("blocked", 8), 3.0, 0.004), (("blocked", 8), 2.9, 0.005),
                     (("run_resident", 4), 3.0, 0.006), (("run_resident", 4), 3.2, 0.003),
                     (("run_resident", 8), 3.0, 0.007), (("run_resident", 8), 3.0, 0.008),
                     (("run_resident", 16), 3.1, 0.009), (("run_resident", 16), 3.0, 0.002)],
    "per_query wins": [(c, 1.4, t) for c, t in [
        (("per_query", 0), 0.001), (("per_query", 0), 0.002),
        (("blocked", 8), 0.003), (("blocked", 8), 0.004),
        (("run_resident", 4), 0.005), (("run_resident", 4), 0.006),
        (("run_resident", 8), 0.007), (("run_resident", 8), 0.008),
        (("run_resident", 16), 0.009), (("run_resident", 16), 0.010)]],
}


@pytest.mark.parametrize("name", sorted(_RECORDINGS))
def test_autotuner_fits_as_the_reference(name):
    """The same recorded timings give the reference's probe order, decision
    and crossover."""
    port, ref = ttune.AutoTuner(), jtune.AutoTuner()
    key = ("x", 8, 32, 8, "float32")
    for cand, sharing, secs in _RECORDINGS[name]:
        assert port.next_probe(key) == ref.next_probe(key)
        port.record(key, cand, sharing, secs)
        ref.record(key, cand, sharing, secs)
        assert port.lookup(key) == ref.lookup(key)
    assert port.next_probe(key) is None and port.lookup(key) is not None
    assert port.decisions() == ref.decisions()
    port.reset()
    assert port.decisions() == {} and port.next_probe(key) == ("per_query", 0)


@pytest.mark.parametrize("crossover,want", [(1.0, "run_resident"),
                                            (1e9, "per_query")])
def test_auto_follows_a_seeded_decision(rng, crossover, want):
    """A fitted decision: grouped at or above the crossover, per-query
    below; the board bound keeps per-query whatever the decision."""
    codes, slots, visit, luts, coarse, spp = _problem(rng, per_probe=False)
    tuner = ttune.AutoTuner()
    tuner.seed(("plain", 8, 32, 8, "float32"),
               {"grouped_mode": "run_resident", "qblk": 4,
                "crossover": crossover})
    args = (_t(codes), _t(slots), _t(visit), _t(luts))
    kw = dict(k=10, coarse=_t(coarse), steps_per_probe=spp,
              pad_block=slots.shape[0] - 1, autotune=tuner)
    stats = {}
    ops.ivf_adc_topk(*args, stats=stats, **kw)
    assert stats["mode"] == want and not stats["probe"]
    assert stats["qblk"] == (4 if want != "per_query" else 0)
    old = ops.BLOCKED_MAX_BOARD_SLOTS
    try:
        ops.BLOCKED_MAX_BOARD_SLOTS = 1
        ops.ivf_adc_topk(*args, stats=stats, **kw)
    finally:
        ops.BLOCKED_MAX_BOARD_SLOTS = old
    assert stats["mode"] == "per_query"


@pytest.mark.parametrize("autotune", ["tuner", "untuned"])
def test_auto_where_no_board_fits_is_the_per_query_grid(rng, monkeypatch,
                                                        autotune):
    """With the grouped grids' board past its bound, 'auto' serves the
    per-query grid bit for bit, probes no candidate, and defers the
    sharing count: read, it is the host probe's."""
    codes, slots, visit, luts, coarse, spp = _problem(rng, per_probe=True)
    pad_block = slots.shape[0] - 1
    args = (_t(codes), _t(slots), _t(visit), _t(luts))
    kw = dict(k=25, coarse=_t(coarse), steps_per_probe=spp,
              pad_block=pad_block)
    want = ops.ivf_adc_topk(*args, mode="per_query", **kw)
    monkeypatch.setattr(ops, "BLOCKED_MAX_BOARD_SLOTS", 0)
    tuner = ttune.AutoTuner(reps=1) if autotune == "tuner" else False
    stats = {}
    got = ops.ivf_adc_topk(*args, stats=stats, autotune=tuner, **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert stats["mode"] == "per_query" and stats["sharing_deferred"]
    assert not stats["probe"] and stats["groups"] == 0
    assert {key: stats[key].item() for key in ("pairs", "blocks", "sharing")} \
        == tivf.visit_sharing(_t(visit), pad_block=pad_block)
    if tuner:
        assert tuner.next_probe(("plain", 8, 32, 8, "float32")) == \
            ("per_query", 0)


def test_auto_where_no_board_fits_counts_nothing_unasked(rng, monkeypatch):
    """``stats=None`` (the mesh front's shards): no sharing count at all."""
    codes, slots, visit, luts, coarse, spp = _problem(rng, per_probe=False)
    args = (_t(codes), _t(slots), _t(visit), _t(luts))
    kw = dict(k=10, coarse=_t(coarse), steps_per_probe=spp,
              pad_block=slots.shape[0] - 1, autotune=ttune.AutoTuner())
    want = ops.ivf_adc_topk(*args, mode="per_query", **kw)

    def refuse(*a, **k):
        raise AssertionError("a sharing count nobody reads")

    monkeypatch.setattr(ops, "BLOCKED_MAX_BOARD_SLOTS", 0)
    monkeypatch.setattr(ops, "visit_sharing", refuse)
    monkeypatch.setattr(tvs, "visit_sharing_device", refuse)
    got = ops.ivf_adc_topk(*args, **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_auto_probes_each_candidate_then_decides(rng):
    """A fresh tuner: each auto batch times the next candidate grid and
    serves its (identical) answer; after every candidate has its reps the
    decision is fitted and stats carry the crossover."""
    codes, slots, visit, luts, coarse, spp = _problem(rng, per_probe=False)
    tuner = ttune.AutoTuner(reps=1)
    args = (_t(codes), _t(slots), _t(visit), _t(luts))
    kw = dict(k=10, coarse=_t(coarse), steps_per_probe=spp,
              pad_block=slots.shape[0] - 1, autotune=tuner)
    want = ops.ivf_adc_topk(*args, mode="per_query", **kw)
    seen = []
    for _ in tuner.candidates:
        stats = {}
        got = ops.ivf_adc_topk(*args, stats=stats, **kw)
        assert stats["probe"]
        seen.append((stats["mode"], stats["qblk"]))
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert [m for m, _ in seen] == [m for m, _ in tuner.candidates]
    assert stats["crossover"] is not None
    assert tuner.lookup(("plain", 8, 32, 8, "float32")) is not None


@pytest.fixture
def one_thread():
    """The plain grids on one thread: with two, a fresh process can spend
    25-90 ms a call waking OpenMP workers, which a timing test cannot
    tell from the work it times."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("cached", [False, True])
def test_auto_probe_times_the_dispatch_as_served(rng, monkeypatch, cached,
                                                 one_thread):
    """A grouped probe's timed call is the dispatch the batch gets: where
    the schedule cache misses it includes building the schedule, where the
    batch is a repeat (a hit) it does not. The schedule build is slowed by
    a known delay so the recorded time shows which."""
    import time as _time
    codes, slots, visit, luts, coarse, spp = _problem(rng, per_probe=False)
    args = (_t(codes), _t(slots), _t(visit), _t(luts))
    kw = dict(k=10, coarse=_t(coarse), steps_per_probe=spp,
              pad_block=slots.shape[0] - 1)
    # one untimed call of each candidate first (its own schedule cache):
    # the first grouped call in a fresh process is slow, and the timed
    # probes must not depend on which test ran before
    for mode in ("per_query", "blocked"):
        ops.ivf_adc_topk(*args, mode=mode, qblk=8,
                         sched_cache=tivf.ScheduleCache(), sched_key=("w",),
                         **kw)
    cache = tivf.ScheduleCache()
    if cached:  # the batch was served before by a grouped grid at qblk 8
        ops.ivf_adc_topk(*args, mode="blocked", qblk=8, sched_cache=cache,
                         sched_key=("b",), **kw)
    delay = 0.05
    build = ops.build_schedule

    def slow_build(*a, **k):
        _time.sleep(delay)
        return build(*a, **k)

    monkeypatch.setattr(ops, "build_schedule", slow_build)
    recorded = []

    class Tuner(ttune.AutoTuner):
        def record(self, key, candidate, sharing, seconds):
            recorded.append((candidate, seconds))
            super().record(key, candidate, sharing, seconds)

    tuner = Tuner(reps=1)
    for _ in range(2):  # per_query, then blocked at qblk 8
        stats = {}
        ops.ivf_adc_topk(*args, stats=stats, autotune=tuner,
                         sched_cache=cache, sched_key=("b",), **kw)
        assert stats["probe"]
    (c0, t0), (c1, t1) = recorded
    assert c0 == ("per_query", 0) and t0 < delay
    assert c1 == ("blocked", 8) and (t1 < delay if cached else t1 >= delay)
    assert cache.stats["hits"] == (1 if cached else 0)


def test_untuned_constants_pick_blocked(rng):
    """autotune=False: blocked at Q >= 32 and sharing >= 2, else per-query."""
    codes, slots, visit, luts, coarse, spp = _problem(rng, per_probe=False,
                                                      C=4, Q=40, nprobe=3)
    kw = dict(k=10, coarse=_t(coarse), steps_per_probe=spp,
              pad_block=slots.shape[0] - 1, autotune=False)
    stats = {}
    ops.ivf_adc_topk(_t(codes), _t(slots), _t(visit), _t(luts), stats=stats,
                     **kw)
    assert stats["sharing"] >= 2 and stats["mode"] == "blocked"
    ops.ivf_adc_topk(_t(codes), _t(slots), _t(visit[:8]), _t(luts[:8]),
                     stats=stats, **dict(kw, coarse=_t(coarse[:8])))
    assert stats["mode"] == "per_query"


# ---------------------------------------------------------------- engine
def _clustered(rng, n, d, n_clusters, scale=2.0):
    centers = rng.normal(size=(n_clusters, d)).astype(np.float32) * scale
    x = (centers[rng.integers(0, n_clusters, n)]
         + rng.normal(size=(n, d)).astype(np.float32))
    return x / np.float32(2 * np.sqrt(d))


@pytest.fixture(scope="module")
def trained():
    """The reference's trained ivf_pq state per metric, and the data."""
    rng = np.random.default_rng(21)
    corpus = _clustered(rng, 1400, 16, 12)
    q = corpus[:40] + 0.1 * rng.normal(size=(40, 16)).astype(np.float32)
    states = {}
    for metric in ("cosine", "l2"):
        jdb = JaxVectorDB("ivf_pq", metric=metric, m=8, ksub=32, nprobe=4,
                          kmeans_iters=4, block_size=8, adc_mode="per_query",
                          use_kernel=False).load(corpus)
        states[metric] = {key: np.asarray(v)
                          for key, v in jdb.index.state_dict().items()}
    return corpus, q, states


def _assert_same(port, ref):
    (ps, pi), (rs, ri) = port, ref
    ps, pi, rs, ri = ps.numpy(), pi.numpy(), np.asarray(rs), np.asarray(ri)
    np.testing.assert_allclose(ps, rs, **TOL)
    for r, j in zip(*np.nonzero(pi != ri)):
        tol = TOL["atol"] + TOL["rtol"] * abs(ps[r, j])
        where = np.flatnonzero(ri[r] == pi[r, j])
        other = rs[r, where[0]] if where.size else rs[r, -1]
        assert abs(other - ps[r, j]) <= tol, (r, j, pi[r], ri[r])


@pytest.mark.parametrize("adaptive", [None, 0.05])
@pytest.mark.parametrize("mode", ["auto", "per_query"] + list(GROUPED))
@pytest.mark.parametrize("metric", ["cosine", "l2"])
def test_ivf_pq_modes_from_reference_state_match(trained, metric, mode,
                                                 adaptive):
    corpus, q, states = trained
    kw = dict(metric=metric, m=8, ksub=32, nprobe=4, block_size=8,
              adc_mode=mode, adaptive_nprobe=adaptive)
    jdb = JaxVectorDB("ivf_pq", use_kernel=False, **kw)
    jdb.index.load_state(states[metric])
    jdb.n, jdb._loaded = jdb.index.size, True
    db = VectorDB("ivf_pq", device="cpu", **kw).load_state(
        from_reference_state(states[metric]))
    for refine in (32, 0):
        jdb.index.refine = db.index.refine = refine
        for Q in (3, 40):
            _assert_same(db.query(q[:Q], k=10), jdb.query(q[:Q], k=10))
    ts, js = db.adc_stats, jdb.adc_stats
    assert ts["batches"] == js["batches"] == 4
    np.testing.assert_allclose(ts["eff_nprobe_sum"], js["eff_nprobe_sum"])
    if mode in GROUPED:
        assert ts[mode] == js[mode] == 4
        assert (ts["sched_cache_hits"], ts["sched_cache_misses"]) == \
            (js["sched_cache_hits"], js["sched_cache_misses"])


def test_ivf_pq_grids_bit_identical(trained):
    """The port's three grids give one answer bit for bit; adaptive probing
    drops probes (eff_nprobe below nprobe) on every grid alike."""
    corpus, q, states = trained
    state = from_reference_state(states["l2"])
    out = {}
    for mode in ("per_query",) + GROUPED:
        db = VectorDB("ivf_pq", metric="l2", adc_mode=mode, refine=0,
                      adaptive_nprobe=0.05, device="cpu").load_state(state)
        out[mode] = db.query(q, k=20)
        st = db.adc_stats
        assert st[mode] == 1 and st["eff_nprobe_sum"] < 4
    for mode in GROUPED:
        assert torch.equal(out[mode][0], out["per_query"][0])
        assert torch.equal(out[mode][1], out["per_query"][1])


def test_schedule_cache_serves_a_repeated_batch(trained):
    """The plan ledger's schedule cache: the same batch again is a hit, a
    different batch of the same bucket a miss; adaptive_nprobe salts the
    plan key."""
    corpus, q, states = trained
    db = VectorDB("ivf_pq", metric="cosine", adc_mode="blocked",
                  device="cpu").load_state(from_reference_state(
                      states["cosine"]))
    db.query(q[:5], k=5)
    db.query(q[:5], k=5)
    db.query(q[5:10], k=5)
    st = db.adc_stats
    assert (st["sched_cache_hits"], st["sched_cache_misses"]) == (1, 2)
    assert db.plan_stats == {"hits": 2, "misses": 1}
    db.index.adaptive_nprobe = 0.1
    db.query(q[:5], k=5)
    assert db.plan_stats == {"hits": 2, "misses": 2}
    assert VectorDB("flat", device="cpu").adc_stats is None


def _plain_numbers(st):
    return all(v is None or type(v) in (int, float) for v in st.values())


def test_adc_stats_read_the_deferred_sharing_as_plain_numbers(trained,
                                                              monkeypatch):
    """Batches served where no board fits count their sharing on the
    device; ``adc_stats`` reads it as a plain float, the same sum as the
    host probe's over the same batches, counts them under
    'sharing_deferred', and each snapshot keeps its values."""
    corpus, q, states = trained
    state = from_reference_state(states["cosine"])
    kw = dict(metric="cosine", m=8, ksub=32, nprobe=4, block_size=8,
              device="cpu")
    batches = (q[:3], q[3:40], q[:40], q[7:8])
    board = ops.BLOCKED_MAX_BOARD_SLOTS
    got = {}
    for name, slots in (("deferred", 0), ("host", board)):
        monkeypatch.setattr(ops, "BLOCKED_MAX_BOARD_SLOTS", slots)
        monkeypatch.setattr(ops, "LEDGER", ttune.AutoTuner())
        db = VectorDB("ivf_pq", **kw).load_state(state)
        for i, b in enumerate(batches):
            db.query(b, k=5)
            if i == 0:
                snap = db.index.adc_stats
                first = dict(snap)
        assert snap == first and snap["batches"] == 1
        st = db.adc_stats
        assert _plain_numbers(st) and _plain_numbers(db.index.adc_stats)
        assert st["batches"] == len(batches)
        got[name] = st
    assert got["deferred"]["sharing_deferred"] == len(batches)
    assert got["deferred"]["per_query"] == len(batches)
    assert got["host"]["sharing_deferred"] == 0
    assert got["deferred"]["sharing_sum"] / len(batches) == \
        got["host"]["sharing_sum"] / len(batches) > 0
    # batches on both paths: only the deferred ones are counted as such
    monkeypatch.setattr(ops, "BLOCKED_MAX_BOARD_SLOTS", 0)
    db = VectorDB("ivf_pq", **kw).load_state(state)
    db.query(batches[0], k=5)
    db.query(batches[1], k=5)
    monkeypatch.setattr(ops, "BLOCKED_MAX_BOARD_SLOTS", board)
    db.query(batches[2], k=5)
    db.query(batches[3], k=5)
    st = db.adc_stats
    assert st["sharing_deferred"] == 2 and st["batches"] == 4
    assert st["sharing_sum"] == pytest.approx(got["host"]["sharing_sum"],
                                              rel=1e-12)
