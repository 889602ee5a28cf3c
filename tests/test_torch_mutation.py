"""Mutation in the port (insert, delete, upsert, compact, reserve) against
the reference, on the CPU.

Both packages start from one trained state (the reference trains it, and
its state crosses through ``convert.from_reference_state``), then take the
same write sequence: inserts that fill tail blocks and spill into new
ones, explicit ids past the id space, deletes with repeated, unknown and
negative ids, upserts that move rows to other clusters and resurrect
deleted ids, ``reserve``, compaction past ``compact_threshold`` and on
request. After every write: the write's return value, ``size``,
``generation``, ``mutation_stats`` (and ``stale_fraction`` /
``needs_retrain`` for pq), the ivf_pq layout array for array, and the
answers to the same queries: ids exact (but between scores equal within
the tolerance) and scores within the ROADMAP's float32 bound (the bf16
flat within the bf16 one). The codes of each batch are compared before it
is written, and a difference is reported as a near-tie or as a real one.

Then the reference's dict-oracle fuzz on the port's ivf_pq (nprobe = C,
re-rank over every candidate: the answer must be brute force over the
live rows), the plan ledger's generation, empty and fully deleted
indexes, and the id-validation errors.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro.core import VectorDB as JaxVectorDB  # noqa: E402
from repro_torch import VectorDB  # noqa: E402
from repro_torch.core.convert import from_reference_state  # noqa: E402
from repro_torch.core.ivf import BlockListLayout  # noqa: E402
from repro_torch.core.mutable import GrowableRows, MutableIndex  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
# cosine queries are normalized in bf16 on both sides, rounded in different
# places (tests/test_torch_engines.py, BF16_TOL)
BF16_COSINE_TOL = dict(atol=2.0 ** -7, rtol=0.0)
D, N0 = 16, 600
LAYOUT_ARRAYS = ("slots", "codes", "block_table", "bcnt", "tail_fill",
                 "block_cluster")


def _clustered(rng, n, n_clusters=8):
    centers = rng.normal(size=(n_clusters, D)).astype(np.float32) * 2.0
    x = (centers[rng.integers(0, n_clusters, n)]
         + rng.normal(size=(n, D)).astype(np.float32))
    return x / np.float32(2 * np.sqrt(D))


def _flat_state(jdb):
    idx = jdb.index
    n = idx.next_id
    state = {"engine": "flat", "metric": idx.metric,
             "corpus": idx._corpus.data[:n], "live": idx._valid.data[:n]}
    if idx._sq is not None:
        state["corpus_sq"] = idx._sq.data[:n]
    return state


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_same(port, ref, tol):
    """Scores rank by rank within tol; ids equal but where two rows'
    scores agree within it."""
    (ps, pi), (rs, ri) = port, ref
    ps, pi = ps.float().numpy(), pi.numpy()
    rs, ri = np.asarray(rs, np.float32), np.asarray(ri)
    assert ps.shape == rs.shape, (ps.shape, rs.shape)
    np.testing.assert_allclose(ps, rs, **tol)
    for r, j in zip(*np.nonzero(pi != ri)):
        t = tol["atol"] + tol["rtol"] * abs(ps[r, j])
        where = np.flatnonzero(ri[r] == pi[r, j])
        other = rs[r, where[0]] if where.size else rs[r, -1]
        assert abs(other - ps[r, j]) <= t, (r, j, pi[r], ri[r])


def _report_choice(got, want, scores, what):
    """Fail unless the two argmax choices agree; name each difference a
    near-tie (the chosen entries' float64 scores within 1e-5 of the row's
    scale) or a real difference."""
    got, want = np.asarray(got), np.asarray(want)
    bad = np.argwhere(got != want)
    if not bad.size:
        return
    lines = []
    for idx in map(tuple, bad):
        s = scores[idx]
        gap = abs(s[got[idx]] - s[want[idx]])
        kind = ("near-tie" if gap <= 1e-5 * max(1.0, np.abs(s).max())
                else "real difference")
        lines.append(f"{what} {idx}: port {got[idx]}, reference {want[idx]},"
                     f" float64 score gap {gap:.3e}: {kind}")
    pytest.fail("\n".join(lines))


def _subspace_scores(codebooks, x):
    """(n, m, ksub) float64 encode scores 2 x.c - |c|^2 per subspace."""
    cb = np.asarray(codebooks, np.float64)
    m, _, dsub = cb.shape
    x = np.asarray(x, np.float64)
    x = np.pad(x, ((0, 0), (0, m * dsub - x.shape[1]))).reshape(len(x), m, dsub)
    return 2 * np.einsum("nmd,mkd->nmk", x, cb) - (cb ** 2).sum(-1)[None]


class Pair:
    """One engine in each package from one trained state, and the checks
    run after every write."""

    def __init__(self, engine, metric, **kw):
        rng = np.random.default_rng(11)
        self.rng = rng
        self.corpus = _clustered(rng, N0)
        self.q = self.corpus[:9] + 0.05 * rng.normal(size=(9, D)).astype(np.float32)
        self.engine, self.metric = engine, metric
        jkw, tkw = dict(kw), dict(kw)
        if engine == "flat" and kw.get("dtype") == "bfloat16":
            import jax.numpy as jnp
            jkw["dtype"], tkw["dtype"] = jnp.bfloat16, torch.bfloat16
        if engine in ("pq", "ivf_pq"):
            jkw["use_kernel"] = False
        if engine == "ivf_pq":
            jkw["adc_mode"] = "per_query"
        self.jdb = JaxVectorDB(engine, metric=metric, **jkw).load(self.corpus)
        state = (_flat_state(self.jdb) if engine == "flat"
                 else {key: np.asarray(v)
                       for key, v in self.jdb.index.state_dict().items()})
        self.db = VectorDB(engine, metric=metric, device="cpu",
                           **tkw).load_state(from_reference_state(state))
        self.tol = (BF16_COSINE_TOL if tkw.get("dtype") is torch.bfloat16
                    and metric == "cosine" else TOL)
        self.check("load")

    def rows(self, n, shift=0.0):
        x = _clustered(self.rng, n)
        return x + np.float32(shift)

    def check_codes(self, vectors):
        """The batch's assignment and codes agree before it is written."""
        if self.engine == "flat":
            return
        jidx, tidx = self.jdb.index, self.db.index
        j = jidx._encode_batch(vectors)
        t = tidx._encode_batch(vectors)
        if self.engine == "ivf_pq":
            rows = np.asarray(j[2], np.float64)
            cent = np.asarray(jidx.centroids, np.float64)
            c_scores = 2 * rows @ cent.T - (cent ** 2).sum(-1)[None]
            _report_choice(_np(t[1]), np.asarray(j[1]), c_scores, "cluster of row")
            resid = rows - cent[np.asarray(j[1])]
            _report_choice(_np(t[0]), np.asarray(j[0]),
                           _subspace_scores(jidx.codebooks, resid), "code of")
        else:
            _report_choice(_np(t[0]), np.asarray(j[0]),
                           _subspace_scores(jidx.codebooks, j[1]), "code of")

    def write(self, op, *args):
        if op in ("insert", "upsert"):
            self.check_codes(args[0])
        want = getattr(self.jdb, op)(*args)
        got = getattr(self.db, op)(*args)
        if op in ("insert", "upsert"):
            np.testing.assert_array_equal(_np(got), np.asarray(want))
        elif op in ("delete", "compact"):
            assert got == want, (op, got, want)
        self.check(f"{op}{args[1:] if op == 'reserve' else ''}")
        return got

    def check(self, ctx):
        jidx, tidx = self.jdb.index, self.db.index
        assert self.db.n == self.jdb.n == tidx.size == jidx.size, ctx
        assert tidx.next_id == jidx.next_id, ctx
        assert self.db.generation == self.jdb.generation, ctx
        assert self.db.mutation_stats == self.jdb.mutation_stats, ctx
        if self.engine == "pq":
            assert tidx.inserted_since_train == jidx.inserted_since_train
            assert tidx.stale_fraction == pytest.approx(jidx.stale_fraction)
            assert tidx.needs_retrain == jidx.needs_retrain, ctx
        if self.engine == "ivf_pq":
            jl, tl = jidx.layout, tidx.layout
            assert (tl.capacity, tl.steps_per_probe, tl.n_blocks, tl.live,
                    tl.tombstones) == (jl.capacity, jl.steps_per_probe,
                                       jl.n_blocks, jl.live, jl.tombstones), ctx
            for name in LAYOUT_ARRAYS:
                np.testing.assert_array_equal(
                    _np(getattr(tl, name)), np.asarray(getattr(jl, name)),
                    err_msg=f"{ctx}: layout {name}")
            assert tl.tombstone_fraction == pytest.approx(jl.tombstone_fraction)
            if tidx.scan_all:
                n = tidx.next_id
                np.testing.assert_array_equal(
                    _np(tidx._valid.data[:n]), np.asarray(jidx._valid.data[:n]))
                live = np.asarray(jidx._valid.data[:n])
                np.testing.assert_array_equal(
                    _np(tidx._codes_rm.data[:n])[live],
                    np.asarray(jidx._codes_rm.data[:n])[live])
        for k in (1, 10):
            _assert_same(self.db.query(self.q, k=k),
                         self.jdb.query(self.q, k=k), self.tol)


def _script(p: Pair):
    """The write sequence both packages take."""
    first = p.write("insert", p.rows(37))
    p.write("insert", p.rows(3), np.array([p.db.index.next_id + 4,
                                           p.db.index.next_id + 1,
                                           p.db.index.next_id + 9]))
    assert p.write("delete", np.array([5, 5, 7, -1, 9999, 640])) \
        == (2 if p.engine == "ivf_pq" else 3)
    gone = np.arange(20, 60)
    p.write("delete", gone)
    # rows copied from far-away ones move clusters; 7 and 30 resurrect
    moved = p.corpus[[300, 450, 10, 520]] + 0.01
    p.write("upsert", moved, np.array([7, 30, 400, int(first[0])]))
    p.write("reserve", *((64, 2) if p.engine == "ivf_pq" else (64,)))
    p.write("insert", p.rows(70, shift=0.02))
    p.write("delete", np.arange(100, 330))          # past compact_threshold
    p.write("compact")
    p.write("insert", p.rows(12))
    p.write("upsert", p.rows(2), np.array([100, 101]))
    p.write("delete", np.array([100, 100, 101]))


# m = 8 subspaces of 64 codewords keep rows' codes distinct, so ADC scores
# do not tie exactly at the refine cut (tests/test_torch_pq.py)
PQ_KW = dict(m=8, ksub=64, kmeans_iters=4)
IVF_KW = dict(PQ_KW, n_clusters=8, nprobe=3, block_size=8)
CASES = ([("flat", m, {}) for m in ("cosine", "l2", "dot")]
         + [("flat", m, {"dtype": "bfloat16"}) for m in ("cosine", "l2", "dot")]
         + [("pq", m, PQ_KW) for m in ("cosine", "l2", "dot")]
         + [("ivf_pq", m, IVF_KW) for m in ("cosine", "l2", "dot")]
         + [("ivf_pq", "cosine", dict(IVF_KW, scan_all=True))])


@pytest.mark.parametrize("engine,metric,kw", CASES,
                         ids=[f"{e}-{m}{'-' + '-'.join(f'{k}' for k in kw if k in ('dtype', 'scan_all'))}"
                              for e, m, kw in CASES])
def test_write_sequence_matches_reference(engine, metric, kw):
    _script(Pair(engine, metric, **kw))


def test_ivf_pq_layout_grows_and_moves_the_pad_block():
    """Inserts past the storage capacity double it (the pad block moves to
    the new last row) and past steps_per_probe double that, as in the
    reference, array for array."""
    p = Pair("ivf_pq", "l2", n_clusters=4, nprobe=4, m=4, ksub=16,
             kmeans_iters=2, block_size=8)
    cap, spp = p.db.index.layout.capacity, p.db.index.layout.steps_per_probe
    gen = p.db.plan_generation
    for _ in range(3):
        p.write("insert", p.rows(400))
    lay = p.db.index.layout
    assert lay.capacity > cap and lay.steps_per_probe > spp
    assert p.db.plan_generation > gen
    assert bool((lay.slots[lay.pad_row] == -1).all())


# ------------------------------------------------------------- fuzz
def _oracle_topk(vecs: dict, q, k: int, metric: str):
    ids = np.asarray(sorted(vecs))
    M = np.stack([vecs[i] for i in ids]).astype(np.float64)
    qq = q.astype(np.float64)
    if metric == "cosine":
        M = M / np.linalg.norm(M, axis=-1, keepdims=True)
        qq = qq / np.linalg.norm(qq, axis=-1, keepdims=True)
        s = qq @ M.T
    elif metric == "dot":
        s = qq @ M.T
    else:
        s = -((qq ** 2).sum(-1)[:, None] - 2 * qq @ M.T + (M ** 2).sum(-1)[None])
    order = np.argsort(-s, axis=-1, kind="stable")[:, :k]
    return np.take_along_axis(s, order, axis=-1), ids[order]


def _check_exact(db, vecs: dict, q, k: int, metric: str, ctx=""):
    """The engine's top k is brute force over the live rows: the same live
    ids but for swaps within the score tolerance, each score the id's own."""
    s, ids = (x.numpy() for x in db.query(q, k=k))
    kk = min(k, len(vecs))
    if kk == 0:
        assert s.shape[1] == 0, ctx
        return
    ref_s, ref_ids = _oracle_topk(vecs, q, kk, metric)
    tol = 1e-3 * max(1.0, float(np.abs(ref_s).max()))
    for r in range(q.shape[0]):
        got = ids[r, :kk]
        assert len(set(got.tolist())) == kk, (ctx, r, got)
        for j, i in enumerate(got):
            assert int(i) in vecs, (ctx, r, j, i)
            one, _ = _oracle_topk({int(i): vecs[int(i)]}, q[r:r + 1], 1, metric)
            assert abs(s[r, j] - one[0, 0]) <= tol, (ctx, r, j)
        boundary = ref_s[r, kk - 1]
        assert s[r, :kk].min() >= boundary - tol, (ctx, r)
        clear = ref_s[r] > boundary + tol
        assert set(ref_ids[r][clear].tolist()) <= set(got.tolist()), (ctx, r)


def _run_fuzz(seed: int, metric: str, n_steps: int = 30, **extra):
    """The reference's seeded fuzz (tests/test_mutation.py) on the port."""
    rng = np.random.default_rng(seed)
    d, n0 = 12, 60
    corpus = rng.normal(size=(n0, d)).astype(np.float32)
    db = VectorDB("ivf_pq", metric=metric, n_clusters=5, nprobe=5, m=4,
                  ksub=32, refine=4096, block_size=8, compact_threshold=0.5,
                  device="cpu", **extra).load(corpus)
    vecs = {i: corpus[i] for i in range(n0)}
    q = rng.normal(size=(3, d)).astype(np.float32)
    _check_exact(db, vecs, q, 8, metric, "after load")
    for step in range(n_steps):
        op = rng.choice(["insert", "delete", "upsert", "compact"],
                        p=[0.45, 0.25, 0.2, 0.1])
        if op == "insert":
            rows = rng.normal(size=(int(rng.integers(1, 6)), d)).astype(np.float32)
            ids = db.insert(rows)
            vecs.update({int(i): r for i, r in zip(ids, rows)})
        elif op == "delete" and vecs:
            take = rng.choice(sorted(vecs), size=min(len(vecs),
                                                     int(rng.integers(1, 5))),
                              replace=False)
            db.delete(take)
            for i in take:
                vecs.pop(int(i))
        elif op == "upsert":
            ids = np.unique(rng.integers(0, db.index.next_id, size=2))
            rows = rng.normal(size=(ids.size, d)).astype(np.float32)
            db.upsert(rows, ids)
            vecs.update({int(i): r for i, r in zip(ids, rows)})
        else:
            db.compact()
        _check_exact(db, vecs, q, 8, metric, f"step {step} ({op})")
    assert db.n == len(vecs)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("metric", ["l2", "cosine", "dot"])
def test_mutation_fuzz_matches_dict_oracle(seed, metric):
    _run_fuzz(seed, metric)


@pytest.mark.parametrize("mode", ["auto", "blocked", "run_resident"])
def test_mutation_fuzz_under_every_grid(mode):
    _run_fuzz(5, "l2", n_steps=20, adc_mode=mode)


@pytest.mark.parametrize("engine", ["flat", "pq"])
@pytest.mark.parametrize("metric", ["cosine", "l2"])
def test_engines_share_the_mutation_protocol(rng, engine, metric):
    corpus = rng.normal(size=(20, D)).astype(np.float32)
    kw = {"pq": dict(m=4, ksub=16, refine=4096)}.get(engine, {})
    db = VectorDB(engine, metric=metric, device="cpu", **kw).load(corpus)
    assert isinstance(db.index, MutableIndex)
    vecs = {i: corpus[i] for i in range(20)}
    new = rng.normal(size=(6, D)).astype(np.float32)
    ids = db.insert(new)
    vecs.update({int(i): r for i, r in zip(ids, new)})
    db.delete([0, 3, 21])
    for i in (0, 3, 21):
        vecs.pop(i)
    up = rng.normal(size=(2, D)).astype(np.float32)
    db.upsert(up, np.array([5, 0]))  # id 0 resurrects
    vecs.update({5: up[0], 0: up[1]})
    db.compact()
    assert db.n == len(vecs) == db.index.size
    q = np.stack([vecs[7], vecs[22]]).astype(np.float32)
    _check_exact(db, vecs, q, 8, metric, engine)
    s, got = db.query(q, k=len(vecs))
    assert 3 not in set(got.reshape(-1).tolist())


# ------------------------------------------------- ledger, edges, errors
def test_plan_generation_bumps_on_growth_not_on_steady_inserts(rng):
    """A write that reallocates a buffer bumps plan_generation once (the
    next query counts a miss); inserts that fit the grown buffer do not.
    Growth takes an eighth of the capacity at least."""
    corpus = rng.normal(size=(64, 8)).astype(np.float32)
    db = VectorDB("flat", device="cpu").load(corpus)
    db.query(corpus[:4], k=3)
    assert db.plan_stats == {"hits": 0, "misses": 1}
    assert db.index.shape_key == (64,)
    db.insert(rng.normal(size=(1, 8)).astype(np.float32))
    assert db.plan_generation == 1 and db.index.shape_key == (72,)
    db.query(corpus[:4], k=3)
    assert db.plan_stats == {"hits": 0, "misses": 2}
    for _ in range(7):
        db.insert(rng.normal(size=(1, 8)).astype(np.float32))
        db.query(corpus[:4], k=3)
    assert db.plan_generation == 1
    assert db.plan_stats == {"hits": 7, "misses": 2}
    db.insert(rng.normal(size=(100, 8)).astype(np.float32))
    assert db.plan_generation == 2 and db.index.shape_key == (172,)
    assert db.reserve(28) == (200,) and db.plan_generation == 3
    assert db.reserve(10) == (200,) and db.plan_generation == 3


def test_ivf_pq_steady_inserts_inside_a_reserved_bucket(rng):
    """The reference's steady-state test: after reserve, 110 insert
    batches keep the shape key and every query hits its plan."""
    corpus = rng.normal(size=(256, 16)).astype(np.float32)
    db = VectorDB("ivf_pq", n_clusters=8, nprobe=4, m=4, ksub=16, refine=0,
                  block_size=8, device="cpu").load(corpus)
    db.reserve(256, 8)
    key, gen = db.index.shape_key, db.plan_generation
    db.query(corpus[:1], k=4)
    for i in range(110):
        db.insert(rng.normal(size=(2, 16)).astype(np.float32))
        db.query(corpus[i % 256][None], k=4)
    assert db.index.shape_key == key and db.plan_generation == gen
    assert db.plan_stats == {"hits": 110, "misses": 1}
    assert db.mutation_stats["inserts"] == 220


def test_growable_rows_growth_step_and_exact_reserve():
    g = GrowableRows.from_array(torch.arange(16.0).reshape(8, 2))
    start, grew = g.append(torch.ones((1, 2)))
    assert (start, grew, g.capacity, g.n) == (8, True, 9, 9)
    assert g.reserve(10) and g.capacity == 10
    assert g.reserve(40) and g.capacity == 40
    assert g.reserve(41) and g.capacity == 45
    assert g.reserve(50, exact=True) and g.capacity == 50
    assert not g.reserve(50)
    assert torch.equal(g.data[:8], torch.arange(16.0).reshape(8, 2))
    assert bool((g.data[9:] == 0).all())


@pytest.mark.parametrize("engine", ["flat", "pq", "ivf_pq"])
def test_empty_and_fully_deleted_index_answer_q_by_0(rng, engine):
    kw = {"pq": dict(m=4, ksub=8), "ivf_pq": dict(m=4, ksub=8, block_size=8)
          }.get(engine, {})
    x = rng.normal(size=(20, 8)).astype(np.float32)
    db = VectorDB(engine, device="cpu", **kw).load(x)
    db.delete(np.arange(20))
    s, i = db.query(np.zeros((2, 8), np.float32), k=3)
    assert s.shape == (2, 0) and i.shape == (2, 0)
    db.insert(x[:2])
    s, i = db.query(x[:1], k=5)
    assert s.shape == (1, 2) and set(i[0].tolist()) == {20, 21}
    with pytest.raises(RuntimeError):
        VectorDB(engine, device="cpu", **kw).query(np.zeros(8), k=1)


def test_empty_flat_load_then_insert_and_delete_all(rng):
    db = VectorDB("flat", device="cpu").load(np.zeros((0, 8), np.float32))
    s, i = db.query(np.zeros((3, 8), np.float32), k=5)
    assert s.shape == (3, 0) and i.shape == (3, 0)
    ids = db.insert(rng.normal(size=(4, 8)).astype(np.float32))
    assert db.query(np.zeros((1, 8), np.float32), k=2)[0].shape == (1, 2)
    db.delete(ids)
    assert db.query(np.zeros((2, 8), np.float32), k=5)[0].shape == (2, 0)


@pytest.mark.parametrize("engine", ["flat", "pq", "ivf_pq"])
def test_insert_and_upsert_id_validation(rng, engine):
    kw = {"pq": dict(m=2, ksub=4), "ivf_pq": dict(m=2, ksub=4, block_size=8)
          }.get(engine, {})
    db = VectorDB(engine, device="cpu", **kw).load(
        rng.normal(size=(10, 4)).astype(np.float32))
    with pytest.raises(ValueError, match="fresh"):
        db.insert(np.ones((1, 4), np.float32), ids=[5])
    with pytest.raises(ValueError, match="existing"):
        db.upsert(np.ones((1, 4), np.float32), ids=[99])
    with pytest.raises(ValueError, match="existing"):
        db.upsert(np.ones((1, 4), np.float32), ids=[-1])
    with pytest.raises(ValueError, match="duplicate"):
        db.insert(np.ones((2, 4), np.float32), ids=[12, 12])
    with pytest.raises(ValueError, match="duplicate"):
        db.upsert(np.ones((2, 4), np.float32), ids=[3, 3])
    with pytest.raises(ValueError, match="explicit ids"):
        db.upsert(np.ones((1, 4), np.float32), None)
    ids = db.insert(np.ones((1, 4), np.float32), ids=[17])  # fresh, gap ok
    assert ids.tolist() == [17] and db.index.next_id == 18
    assert db.n == 11  # the gap ids 10..16 never existed
    assert db.mutation_stats == {"inserts": 1, "deletes": 0, "upserts": 0,
                                 "compactions": 0}


def test_write_errors_name_the_engine_and_the_queue_item(rng):
    x = rng.normal(size=(32, 8)).astype(np.float32)
    with pytest.raises(RuntimeError, match="insert before load"):
        VectorDB("flat", device="cpu").insert(x)
    lsh = VectorDB("lsh", device="cpu").load(x)
    with pytest.raises(NotImplementedError, match="engine 'lsh' does not "
                                                  "support insert"):
        lsh.insert(x[:1])
    db = VectorDB("flat", device="cpu").load(x)
    # metadata landed with filtered search (Queue 1, item 4): a malformed
    # batch is refused before the write applies
    with pytest.raises(ValueError, match="meta column"):
        db.insert(x[:1], meta={"a": [1, 2]})
    with pytest.raises(TypeError, match="Predicate"):
        db.query(x[:1], where=object())
    assert db.n == 32 and db.index.next_id == 32
    with pytest.raises(ValueError, match="unknown write kind"):
        db.apply_write("truncate")
    assert db.apply_write("insert", x[:2]).tolist() == [32, 33]
    assert db.apply_write("delete", ids=[32, 32]) == 2
    assert db.apply_write("compact") == {"dropped_tombstones": 0}


def test_block_layout_append_spill_and_slack(rng):
    lay = BlockListLayout.from_assign(
        torch.zeros(5, dtype=torch.int64), 3, blk=8,
        payload=torch.as_tensor(rng.integers(0, 255, (5, 4)), dtype=torch.uint8))
    assert int(lay.bcnt[0]) == 1 and int(lay.tail_fill[0]) == 5
    lay.insert_rows(torch.arange(5, 8), torch.zeros(3, dtype=torch.int64),
                    torch.zeros((3, 4), dtype=torch.uint8))
    assert int(lay.bcnt[0]) == 1 and int(lay.tail_fill[0]) == 8
    lay.insert_rows(torch.tensor([8]), torch.tensor([0]),
                    torch.zeros((1, 4), dtype=torch.uint8))
    assert int(lay.bcnt[0]) == 2 and int(lay.tail_fill[0]) == 1
    for c in range(3):
        rows = lay.block_table[c, : int(lay.bcnt[c])].long()
        used = int((lay.slots[rows] >= 0).sum())
        assert int(lay.bcnt[c]) * lay.blk - used <= lay.blk - 1


def test_block_layout_compact_keeps_shapes(rng):
    assign = torch.as_tensor(rng.integers(0, 4, size=50))
    lay = BlockListLayout.from_assign(
        assign, 4, blk=8,
        payload=torch.as_tensor(rng.integers(0, 255, (50, 4)), dtype=torch.uint8))
    key = lay.shape_key
    assert lay.delete_rows(torch.arange(0, 50, 2)) == 25
    assert lay.tombstone_fraction == pytest.approx(0.5)
    stats = lay.compact()
    assert stats["dropped_tombstones"] == 25
    assert lay.shape_key == key
    assert lay.tombstone_fraction == 0.0 and lay.live == 25
    assert all(lay.contains(i) for i in range(1, 50, 2))
    assert not any(lay.contains(i) for i in range(0, 50, 2))
    assert not lay.contains(-1) and not lay.contains(10 ** 6)


@pytest.mark.parametrize("engine,kw", [("flat", {}), ("pq", {}),
                                       ("ivf_pq", {}),
                                       ("ivf_pq", {"scan_all": True})])
def test_a_growing_write_frees_the_old_buffers(rng, engine, kw):
    """The query-side tensors are re-pointed in the write that grows a
    buffer: no reference to the old storage outlives that write (at 8.8M
    rows the old re-rank corpus is 27.2 GB)."""
    import gc
    import weakref
    x = _clustered(rng, 300)
    if engine != "flat":
        kw = dict(kw, m=4, ksub=16, n_clusters=4) if engine == "ivf_pq" \
            else dict(kw, m=4, ksub=16)
    db = VectorDB(engine, metric="dot", device="cpu", **kw).load(x)
    idx = db.index
    held = [weakref.ref(g.data) for g in (idx._corpus, idx._sq,
                                           getattr(idx, "_codes", None),
                                           getattr(idx, "_codes_rm", None))
            if g is not None]
    db.insert(_clustered(rng, 40))  # past capacity: every buffer grows
    gc.collect()
    assert held and all(r() is None for r in held)
    assert idx.corpus is idx._corpus.data
    db.query(x[:2], k=3)
