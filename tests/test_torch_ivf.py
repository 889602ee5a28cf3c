"""The port's plain IVF engine (``VectorDB("ivf")``) against the
reference's, on the CPU.

The reference trains (its k-means draws from ``jax.random``), and its
trained state crosses as a dict of its attributes (it has no
``state_dict``): centroids, the bucket table and its fills, the corpus
and |c|^2. Both packages then answer the same queries (ids exact but
between scores equal within the bound, scores within atol = rtol = 1e-5,
the bf16 bound for bf16 cosine) for every metric, float32 and bf16, k of
1 and 10 and nprobe of 1 and C. The port's query chunks, forced with a
tiny gather budget, give what one chunk gives. One write script through
both packages keeps the bucket table, its capacity and fills equal after
every step. Then the reference's dict-oracle test, the delete-twice
count, filtered queries with the nprobe boost, the port's own training
against its own ``flat`` and the refusal to snapshot.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402
import repro.search as R  # noqa: E402
from repro.core import VectorDB as JaxVectorDB  # noqa: E402

from repro_torch import VectorDB  # noqa: E402
from repro_torch.core import ivf as IVF  # noqa: E402
from repro_torch.core.convert import from_reference_state  # noqa: E402
from repro_torch.search import Eq, Range  # noqa: E402
from test_torch_engines import BF16_TOL, TOL  # noqa: E402
from test_torch_mutation import _assert_same, _check_exact  # noqa: E402

METRICS = ["cosine", "l2", "dot"]
D_, N0, C = 16, 600, 8


def _clustered(rng, n, n_clusters=C):
    centers = rng.normal(size=(n_clusters, D_)).astype(np.float32) * 2.0
    x = (centers[rng.integers(0, n_clusters, n)]
         + rng.normal(size=(n, D_)).astype(np.float32))
    return x / np.float32(2 * np.sqrt(D_))


def ivf_ref_state(jidx) -> dict:
    """The reference IVFIndex's trained state from its attributes (the
    engine has no state_dict): centroids (bf16 ones widened exactly to
    float32), the bucket table, the fills, the float32 corpus mirror and
    |c|^2 over the id space."""
    n = jidx.next_id
    state = {"engine": "ivf", "metric": jidx.metric,
             "centroids": np.asarray(jidx.centroids.astype(jnp.float32)),
             "buckets": jidx._buckets, "fill": jidx._fill,
             "corpus": jidx._corpus.data[:n], "generation": jidx.generation}
    if jidx._sq is not None:
        state["corpus_sq"] = jidx._sq.data[:n]
    return state


def _pair(metric, dtype="float32", seed=11, **kw):
    rng = np.random.default_rng(seed)
    corpus = _clustered(rng, N0)
    q = corpus[:9] + 0.05 * rng.normal(size=(9, D_)).astype(np.float32)
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    kw = dict(dict(n_clusters=C, nprobe=3, kmeans_iters=4), **kw)
    jdb = JaxVectorDB("ivf", metric=metric, dtype=jdt, **kw).load(corpus)
    db = VectorDB("ivf", metric=metric, dtype=tdt, device="cpu",
                  **kw).load_state(from_reference_state(
                      ivf_ref_state(jdb.index)))
    return db, jdb, corpus, q, rng


def _tol(metric, dtype):
    return BF16_TOL[metric] if dtype == "bfloat16" else TOL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("metric", METRICS)
def test_ivf_from_reference_state_matches(metric, dtype):
    db, jdb, _, q, _ = _pair(metric, dtype)
    assert db.index.cap == jdb.index.cap and db.n == jdb.n
    for nprobe in (1, C):
        db.index.nprobe = jdb.index.nprobe = nprobe
        for k in (1, 10):
            _assert_same(db.query(q, k=k), jdb.query(q, k=k),
                         _tol(metric, dtype))


@pytest.mark.parametrize("metric", METRICS)
def test_ivf_query_chunks_equal_one_chunk(metric, monkeypatch):
    """A gather budget of one candidate row forces a chunk a query; the
    answer is the one-chunk answer bit for bit."""
    db, _, _, q, _ = _pair(metric)
    whole = db.query(q, k=10)
    monkeypatch.setattr(IVF, "GATHER_BYTES", 4)
    chunked = db.query(q, k=10)
    for a, b in zip(whole, chunked):
        assert torch.equal(a, b)


def test_ivf_k_above_the_probed_slots():
    """k past nprobe x cap: every probed slot, then (-inf, -1), as the
    reference pads it; pads and tombstones never surface as ids."""
    db, jdb, _, q, _ = _pair("l2", nprobe=1)
    k = db.index.cap + 5
    db.delete(np.arange(0, 40))
    jdb.delete(np.arange(0, 40))
    s, i = db.query(q, k=k, bucketize=False)
    js, ji = jdb.query(q, k=k, bucketize=False)
    assert s.shape == (9, k) == np.asarray(js).shape
    _assert_same((s, i), (js, ji), TOL)
    assert set(i[torch.isneginf(s)].tolist()) <= {-1}
    assert not set(i.reshape(-1).tolist()) & set(range(40))


class WritePair:
    """The same writes through both packages; after each, the write's
    result, size, generation, mutation_stats, the bucket table, its
    capacity and fills, and the answers are compared."""

    def __init__(self, metric, dtype="float32"):
        self.db, self.jdb, self.corpus, self.q, self.rng = _pair(metric, dtype)
        self.tol = _tol(metric, dtype)
        self.check()

    def rows(self, n, shift=0.0):
        pick = self.rng.integers(0, N0, n)
        return (self.corpus[pick] + shift
                + 0.02 * self.rng.normal(size=(n, D_)).astype(np.float32))

    def write(self, kind, *args):
        got = getattr(self.db, kind)(*args)
        want = getattr(self.jdb, kind)(*args)
        if kind in ("insert", "upsert"):
            assert got.tolist() == np.asarray(want).tolist()
        else:
            assert got == want, (kind, got, want)
        self.check()
        return got

    def check(self):
        t, j = self.db.index, self.jdb.index
        assert t.size == j.size and self.db.n == self.jdb.n
        assert t.generation == j.generation
        assert t.mutation_stats == j.mutation_stats
        assert t.cap == j.cap
        np.testing.assert_array_equal(t._buckets.numpy(), j._buckets)
        np.testing.assert_array_equal(t._fill.numpy(), j._fill)
        for k in (1, 10):
            _assert_same(self.db.query(self.q, k=k),
                         self.jdb.query(self.q, k=k), self.tol)


def _script(p: WritePair):
    first = p.write("insert", p.rows(37))
    nid = p.db.index.next_id
    p.write("insert", p.rows(3), np.array([nid + 4, nid + 1, nid + 9]))
    # 5 and 7 are live, 5 twice counts once; -1, 9999 and the gap id 640
    # are not
    assert p.write("delete", np.array([5, 5, 7, -1, 9999, 640])) == 2
    p.write("delete", np.arange(20, 60))
    # rows copied from far-away ones move clusters; 7 and 30 resurrect
    moved = p.corpus[[300, 450, 10, 520]] + 0.01
    p.write("upsert", moved, np.array([7, 30, 400, int(first[0])]))
    # 300 near-copies of one row fill one bucket row past the capacity
    cap = p.db.index.cap
    p.write("insert", np.repeat(p.corpus[3:4], 300, 0)
            + 0.01 * p.rng.normal(size=(300, D_)).astype(np.float32))
    assert p.db.index.cap > cap
    p.write("delete", np.arange(100, 330))
    p.write("compact")
    p.write("insert", p.rows(12))
    p.write("upsert", p.rows(2), np.array([100, 101]))
    assert p.write("delete", np.array([100, 100, 101])) == 2
    p.write("compact")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("metric", METRICS)
def test_ivf_write_script_matches_reference(metric, dtype):
    _script(WritePair(metric, dtype))


def test_ivf_compact_keeps_capacity_and_positions():
    """compact repacks each row's live slots in order, keeps cap, and the
    position map names every live id's new slot."""
    p = WritePair("l2")
    p.write("delete", np.arange(0, 600, 3))
    cap = p.db.index.cap
    stats = p.write("compact")
    assert stats["dropped_tombstones"] == 200 and p.db.index.cap == cap
    idx = p.db.index
    flat = idx._buckets.reshape(-1)
    live = torch.nonzero(flat >= 0)[:, 0]
    assert torch.equal(idx._pos[flat[live].long()], live)
    assert int((idx._pos >= 0).sum()) == idx.size == 400


@pytest.mark.parametrize("metric", ["cosine", "l2"])
def test_ivf_shares_the_mutation_protocol(metric):
    """The reference's dict-oracle test (tests/test_mutation.py, ``ivf``):
    with every cluster probed the engine is exact, so the answers are
    brute force over the live rows, and dead ids never come back."""
    rng = np.random.default_rng(0)
    corpus = rng.normal(size=(20, D_)).astype(np.float32)
    db = VectorDB("ivf", metric=metric, n_clusters=4, nprobe=4,
                  device="cpu").load(corpus)
    vecs = {i: corpus[i] for i in range(20)}
    new = rng.normal(size=(6, D_)).astype(np.float32)
    ids = db.insert(new)
    vecs.update({int(i): r for i, r in zip(ids, new)})
    db.delete([0, 3, 21])
    for i in (0, 3, 21):
        vecs.pop(i)
    up = rng.normal(size=(2, D_)).astype(np.float32)
    db.upsert(up, np.array([5, 0]))  # id 0 resurrects
    vecs.update({5: up[0], 0: up[1]})
    db.compact()
    assert db.n == len(vecs) == db.index.size
    q = np.stack([vecs[7], vecs[22]]).astype(np.float32)
    _check_exact(db, vecs, q, 8, metric, "ivf")
    _, got = db.query(q, k=len(vecs))
    assert 3 not in set(got.reshape(-1).tolist())


def test_ivf_delete_counts_an_id_given_twice_once():
    db, jdb, _, _, _ = _pair("dot")
    assert db.delete([5, 5]) == jdb.delete([5, 5]) == 1
    assert db.delete([5]) == jdb.delete([5]) == 0
    assert db.index.generation == jdb.index.generation == 1


def _meta(n):
    return {"tag": (np.arange(n) % 100).tolist()}


@pytest.mark.parametrize("metric", METRICS)
def test_ivf_filtered_with_the_nprobe_boost_matches_reference(metric):
    """Filtered queries at 1 %, 10 % and 50 % selectivity: the boost (x4,
    x4, x2) widens the probe in both packages, the answers agree and stay
    inside the bitmap, and an all-true filter is the unfiltered answer."""
    db, jdb, corpus, q, _ = _pair(metric)
    db.metastore.put(np.arange(N0), _meta(N0))
    jdb.metastore.put(np.arange(N0), _meta(N0))
    for port, ref in ((Eq("tag", 7), R.Eq("tag", 7)),
                      (Range("tag", hi=9), R.Range("tag", hi=9)),
                      (Range("tag", hi=49), R.Range("tag", hi=49))):
        got = db.query(q, k=10, where=port)
        _assert_same(got, jdb.query(q, k=10, where=ref), TOL)
        ids = got[1][got[1] >= 0].numpy()
        assert db.metastore.mask(port, N0)[ids].all()
    assert db.filter_stats["nprobe_boosts"] == \
        jdb.filter_stats["nprobe_boosts"] == 3
    plain = db.query(q, k=10)
    every = db.query(q, k=10, where=Range("tag", lo=0))
    assert all(torch.equal(a, b) for a, b in zip(plain, every))


@pytest.mark.parametrize("metric", METRICS)
def test_ivf_own_training_recall(metric):
    """The port trains its own centroids; recall@10 against its own exact
    engine clears the reference CI's 0.8."""
    rng = np.random.default_rng(3)
    corpus = _clustered(rng, 4096, 24)
    q = corpus[rng.choice(4096, 40, replace=False)] \
        + 0.05 * rng.normal(size=(40, D_)).astype(np.float32)
    flat = VectorDB("flat", metric=metric, device="cpu").load(corpus)
    db = VectorDB("ivf", metric=metric, nprobe=8, device="cpu").load(corpus)
    assert db.index.centroids.shape[0] == 64  # floor(sqrt(4096))
    _, want = flat.query(q, k=10)
    _, got = db.query(q, k=10)
    recall = np.mean([len(set(got[r].tolist()) & set(want[r].tolist())) / 10
                      for r in range(40)])
    assert recall >= 0.8, recall


def test_ivf_refuses_snapshots(tmp_path):
    """As the reference's IVFIndex, the port's has no state_dict: save and
    restore refuse, and so does the snapshot cadence."""
    db, _, _, _, _ = _pair("l2")
    with pytest.raises(NotImplementedError, match="persistence"):
        db.save_index(str(tmp_path))
    with pytest.raises(NotImplementedError, match="persistence"):
        VectorDB("ivf", device="cpu").restore_index(str(tmp_path))
    with pytest.raises(NotImplementedError, match="persistence"):
        db.attach_wal(str(tmp_path), snapshot_every_bytes=1 << 20)
