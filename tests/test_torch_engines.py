"""The port's engines against the JAX package's, on the CPU.

A JAX ``VectorDB`` is loaded (trained by the reference), its state crosses
into the port through ``core.convert.from_reference_state``, and both
answer the same queries: ids equal, scores within atol = rtol = 1e-5, for
cosine, l2 and dot under each table dtype, with and without the exact
re-rank. K-means draws from different generators in the two frameworks,
so the port's own training is held to recall instead: recall@10 >= 0.8
against its own flat engine, the reference CI's bar.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro.core import VectorDB as JaxVectorDB  # noqa: E402
from repro_torch import VectorDB  # noqa: E402
from repro_torch.core.convert import from_reference_state  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
METRICS = ["cosine", "l2", "dot"]


def _clustered(rng, n, d, n_clusters, scale=2.0):
    """Clusters at unit-order norms: l2 scores -(|q|^2 - 2 q.c + |c|^2)
    cancel, so their float32 error scales with |q|^2 + |c|^2, and unit-order
    rows keep it inside the 1e-5 tolerance."""
    centers = rng.normal(size=(n_clusters, d)).astype(np.float32) * scale
    x = (centers[rng.integers(0, n_clusters, n)]
         + rng.normal(size=(n, d)).astype(np.float32))
    return x / np.float32(2 * np.sqrt(d))


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    corpus = _clustered(rng, 1200, 16, 12)
    q = corpus[:9] + 0.1 * rng.normal(size=(9, 16)).astype(np.float32)
    return corpus, q


def _flat_state(jdb):
    """The JAX flat engine keeps its rows in host mirrors and has no
    state_dict; its state is those mirrors."""
    idx = jdb.index
    n = idx.next_id
    state = {"engine": "flat", "metric": idx.metric,
             "corpus": idx._corpus.data[:n], "live": idx._valid.data[:n]}
    if idx._sq is not None:
        state["corpus_sq"] = idx._sq.data[:n]
    return state


def _assert_same(port, ref, tol=TOL):
    """Scores rank by rank within ``tol``; ids equal, except that two rows
    whose scores agree within it may trade places (the tables and query
    norms are built by different float32 code, so a near-tie can fall
    either way)."""
    (ps, pi), (rs, ri) = port, ref
    ps, pi = ps.float().numpy(), pi.numpy()
    rs, ri = np.asarray(rs, np.float32), np.asarray(ri)
    np.testing.assert_allclose(ps, rs, **tol)
    bound = tol
    for r, j in zip(*np.nonzero(pi != ri)):
        tol = bound["atol"] + bound["rtol"] * abs(ps[r, j])
        where = np.flatnonzero(ri[r] == pi[r, j])
        other = rs[r, where[0]] if where.size else rs[r, -1]
        assert abs(other - ps[r, j]) <= tol, (r, j, pi[r], ri[r])


@pytest.mark.parametrize("lut_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("metric", METRICS)
def test_ivf_pq_from_reference_state_matches(data, metric, lut_dtype):
    corpus, q = data
    kw = dict(metric=metric, m=4, nprobe=3, ksub=64, kmeans_iters=4,
              lut_dtype=lut_dtype)
    jdb = JaxVectorDB("ivf_pq", adc_mode="per_query", use_kernel=False,
                      **kw).load(corpus)
    state = {key: np.asarray(v) for key, v in jdb.index.state_dict().items()}
    db = VectorDB("ivf_pq", device="cpu", **kw).load_state(
        from_reference_state(state))
    assert db.index.spp == jdb.index.spp
    for refine in (32, 0):
        jdb.index.refine = db.index.refine = refine
        for k in (1, 10):
            _assert_same(db.query(q, k=k), jdb.query(q, k=k))


@pytest.mark.parametrize("metric", METRICS)
def test_flat_matches_reference(data, metric):
    corpus, q = data
    jdb = JaxVectorDB("flat", metric=metric).load(corpus)
    from_state = VectorDB("flat", metric=metric, device="cpu").load_state(
        from_reference_state(_flat_state(jdb)))
    loaded = VectorDB("flat", metric=metric, device="cpu").load(corpus)
    for k in (10, 200):
        ref = jdb.query(q, k=k)
        _assert_same(from_state.query(q, k=k), ref)
        _assert_same(loaded.query(q, k=k), ref)


def test_flat_k_above_live_rows(data):
    """k above the row count: every row, then nothing past it."""
    corpus, q = data
    jdb = JaxVectorDB("flat", metric="l2").load(corpus[:25])
    db = VectorDB("flat", metric="l2", device="cpu").load(corpus[:25])
    s, i = db.query(q, k=40)
    assert s.shape == (9, 25)
    _assert_same((s, i), jdb.query(q, k=40))


@pytest.mark.parametrize("metric", METRICS)
def test_ivf_pq_own_training_recall(metric):
    """The port trains its own centroids and codebooks; recall@10 against
    its own exact engine clears the reference CI's 0.8."""
    rng = np.random.default_rng(3)
    corpus = _clustered(rng, 4096, 32, 24)
    q = corpus[rng.choice(4096, 40, replace=False)] \
        + 0.05 * rng.normal(size=(40, 32)).astype(np.float32)
    flat = VectorDB("flat", metric=metric, device="cpu").load(corpus)
    db = VectorDB("ivf_pq", metric=metric, m=8, device="cpu").load(corpus)
    _, truth = flat.query(q, k=10)
    _, got = db.query(q, k=10)
    recall = np.mean([len(set(got[r].tolist()) & set(truth[r].tolist())) / 10
                      for r in range(len(q))])
    assert recall >= 0.8, recall


def test_ivf_pq_state_round_trip(data):
    """The port's own state_dict loads back into an engine that answers
    the same, and its leaves have the reference's snapshot names."""
    corpus, q = data
    db = VectorDB("ivf_pq", metric="l2", m=4, ksub=32, device="cpu").load(corpus)
    state = db.index.state_dict()
    assert {"codebooks", "codes", "centroids", "buckets", "live", "d"} <= set(state)
    again = VectorDB("ivf_pq", metric="l2", m=4, ksub=32,
                     device="cpu").load_state(state)
    s0, i0 = db.query(q, k=10)
    s1, i1 = again.query(q, k=10)
    np.testing.assert_array_equal(i0.numpy(), i1.numpy())
    np.testing.assert_array_equal(s0.numpy(), s1.numpy())


def test_bucketize_pads_and_slices(data):
    """Q=3 pads to the plan bucket of 4 with the last query repeated; the
    first 3 rows equal the unpadded answer, and the ledger counts one miss
    then one hit."""
    corpus, q = data
    db = VectorDB("ivf_pq", metric="dot", m=4, ksub=32, device="cpu").load(corpus)
    s, i = db.query(q[:3], k=5)
    s2, i2 = db.query(q[:3], k=5, bucketize=False)
    assert s.shape == (3, 5)
    np.testing.assert_array_equal(i.numpy(), i2.numpy())
    np.testing.assert_array_equal(s.numpy(), s2.numpy())
    assert db.plan_stats == {"hits": 0, "misses": 1}
    db.query(q[:4], k=5)
    assert db.plan_stats == {"hits": 1, "misses": 1}


def test_state_for_another_metric_is_refused(data):
    corpus, _ = data
    state = VectorDB("flat", metric="dot", device="cpu").load(corpus).index.state_dict()
    with pytest.raises(ValueError, match="metric"):
        VectorDB("flat", metric="l2", device="cpu").load_state(state)


@pytest.mark.parametrize("kw,err,match", [
    (dict(where=object()), TypeError, "Predicate"),
    (dict(hybrid=0.5), RuntimeError, "enable_lexical")])
def test_filtered_and_hybrid_are_not_ported_yet(data, kw, err, match):
    """Filtered and hybrid search landed (tests/test_torch_filtered.py);
    what a query still refuses is a malformed predicate and a hybrid query
    before ``enable_lexical``."""
    corpus, q = data
    db = VectorDB("flat", device="cpu").load(corpus)
    with pytest.raises(err, match=match):
        db.query(q, k=3, **kw)


def test_chunked_training_and_encoding_match_whole(data, monkeypatch):
    """k-means, assignment, PQ training and encoding walk the rows in
    chunks sized by ``SCORE_BUDGET``; a budget of a few rows gives the same
    index as one chunk."""
    from repro_torch.core import ivf
    corpus, q = data
    kw = dict(metric="l2", m=4, ksub=32, kmeans_iters=3, device="cpu")
    whole = VectorDB("ivf_pq", **kw).load(corpus)
    monkeypatch.setattr(ivf, "SCORE_BUDGET", 7 * 32 * 4)
    chunked = VectorDB("ivf_pq", **kw).load(corpus)
    for key in ("centroids", "codebooks"):
        np.testing.assert_allclose(getattr(chunked.index, key).numpy(),
                                   getattr(whole.index, key).numpy(),
                                   atol=1e-5, rtol=1e-5)
    assert torch.equal(chunked.index.layout.codes, whole.index.layout.codes)
    assert torch.equal(chunked.index.layout.slots, whole.index.layout.slots)


def test_contiguous_range_block_lists_match_layout(data):
    """build_block_lists' contiguous ranges (bucket codes, ids, bstart,
    bcnt), turned into a block table by block_table_from_ranges, give
    ivf_pq_search the same answer as the layout's own block table."""
    from repro_torch.core.ivf import build_block_lists
    from repro_torch.core.pq import block_table_from_ranges, ivf_pq_search
    corpus, q = data
    db = VectorDB("ivf_pq", metric="dot", m=4, ksub=32, refine=0,
                  device="cpu").load(corpus)
    idx = db.index
    assign = idx.layout.assign_of(idx.n)
    slots, bstart, bcnt, spp = build_block_lists(assign, idx.centroids.shape[0],
                                                 blk=idx.block_size)
    codes_rm = idx.layout.gather_payload(idx.n)
    bucket_codes = codes_rm[slots.clamp(min=0).long()]
    q = torch.as_tensor(q)
    kw = dict(metric="dot", k=10, nprobe=idx.nprobe)
    s0, i0 = ivf_pq_search(idx.codebooks, idx.centroids,
                           (idx.codes_bm, idx.bucket_ids, idx.block_table),
                           None, q, steps_per_probe=idx.spp, **kw)
    s1, i1 = ivf_pq_search(idx.codebooks, idx.centroids,
                           (bucket_codes, slots,
                            block_table_from_ranges(bstart, bcnt, spp)),
                           None, q, steps_per_probe=spp, **kw)
    np.testing.assert_array_equal(i0.numpy(), i1.numpy())
    np.testing.assert_array_equal(s0.numpy(), s1.numpy())


def _bf16_bound(q, corpus, metric):
    """|bf16 flat - float32 flat| per query: q and c each move by at most
    2^-9 of themselves when rounded to bf16 (2^-8 for a cosine q, which is
    normalized in bf16 after the cast), so q.c moves by at most
    2^-7 |q| max|c|; l2 adds the same on 2 q.c and on |q|^2."""
    qn = np.linalg.norm(q, axis=1)[:, None]
    cn = np.linalg.norm(corpus, axis=1).max()
    if metric == "cosine":
        qn, cn = np.ones_like(qn), 1.0
    b = 2.0 ** -7 * qn * cn
    if metric == "l2":
        b = 2 * b + 2.0 ** -7 * qn ** 2
    return b + 1e-5


# a cosine q is normalized in bf16 on both sides, but XLA and PyTorch
# round the bf16 norm in different places (1 bf16 ulp), so cosine scores
# are held to the bf16 bound instead of TOL
BF16_TOL = {"dot": TOL, "l2": TOL, "cosine": dict(atol=2.0 ** -7, rtol=0.0)}


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("k", [1, 10, 64])
def test_flat_bf16_matches_reference(data, metric, k):
    """VectorDB("flat", dtype=bfloat16) against the reference's flat engine
    at dtype=bfloat16, loaded from the vectors and through
    ``from_reference_state``: ids equal but for near-ties, scores within
    BF16_TOL; and against the port's float32 flat within the bf16 bound."""
    import jax.numpy as jnp
    corpus, q = data
    jdb = JaxVectorDB("flat", metric=metric, dtype=jnp.bfloat16).load(corpus)
    loaded = VectorDB("flat", metric=metric, dtype=torch.bfloat16,
                      device="cpu").load(corpus)
    from_state = VectorDB("flat", metric=metric, dtype="bfloat16",
                          device="cpu").load_state(
        from_reference_state(_flat_state(jdb)))
    assert loaded.index.corpus.dtype == torch.bfloat16
    ref = jdb.query(q, k=k)
    tol = BF16_TOL[metric]
    for db in (loaded, from_state):
        got = db.query(q, k=k)
        _assert_same(got, ref, tol)
    s32, _ = VectorDB("flat", metric=metric, device="cpu").load(
        corpus).query(q, k=k)
    s16 = loaded.query(q, k=k)[0].numpy()
    assert np.all(np.abs(s16 - s32.numpy()) <= _bf16_bound(q, corpus, metric))


def test_flat_bf16_state_round_trip_and_dtype_checks(data):
    """state_dict keeps the dtype and the bf16 corpus; a state of another
    dtype, and a corpus dtype the kernel does not take, are refused."""
    corpus, q = data
    db = VectorDB("flat", metric="l2", dtype=torch.bfloat16,
                  device="cpu").load(corpus)
    state = db.index.state_dict()
    assert state["dtype"] == "bfloat16"
    assert state["corpus"].dtype == torch.bfloat16
    assert state["corpus_sq"].dtype == torch.float32
    # |c|^2 of the float32 rows, before the cast (as the reference's)
    np.testing.assert_allclose(state["corpus_sq"].numpy(),
                               np.sum(np.square(corpus), axis=1), rtol=1e-6)
    again = VectorDB("flat", metric="l2", dtype=torch.bfloat16,
                     device="cpu").load_state(state)
    for a, b in zip(again.query(q, k=10), db.query(q, k=10)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="dtype|bfloat16"):
        VectorDB("flat", metric="l2", device="cpu").load_state(state)
    for bad in (torch.float16, "int8"):
        with pytest.raises(ValueError, match="corpus dtype"):
            VectorDB("flat", dtype=bad, device="cpu")


def test_plan_key_is_the_callers_dtype(data):
    """A bf16 batch after a float32 batch of the same shape is a new plan
    (a miss) in both packages; the same dtype again is a hit."""
    import jax.numpy as jnp
    corpus, q = data
    jdb = JaxVectorDB("flat", metric="dot").load(corpus)
    db = VectorDB("flat", metric="dot", device="cpu").load(corpus)
    jdb.query(jnp.asarray(q, jnp.float32), k=5)
    jdb.query(jnp.asarray(q, jnp.bfloat16), k=5)
    db.query(torch.as_tensor(q), k=5)
    db.query(torch.as_tensor(q).to(torch.bfloat16), k=5)
    assert jdb.plan_stats == db.plan_stats == {"hits": 0, "misses": 2}
    jdb.query(jnp.asarray(q, jnp.bfloat16), k=5)
    db.query(torch.as_tensor(q).to(torch.bfloat16), k=5)
    db.query(q.astype(np.float64), k=5)  # float64 plans as float32, as in JAX
    jdb.query(q.astype(np.float64), k=5)
    assert jdb.plan_stats == db.plan_stats == {"hits": 2, "misses": 2}


@pytest.mark.parametrize("metric,scan_all", [("l2", False), ("cosine", False),
                                             ("dot", True)])
def test_ivf_pq_memory_bytes_matches_reference(metric, scan_all):
    """memory_bytes counts what the reference's counts (layout, codebooks,
    centroids, scan_all's row-major codes and assignments, |c|^2, and the
    raw corpus on request) on one state carried across; 1024 rows, so the
    reference's power-of-two capacity equals the port's row count."""
    rng = np.random.default_rng(11)
    corpus = _clustered(rng, 1024, 16, 8)
    kw = dict(metric=metric, m=4, ksub=32, kmeans_iters=3, scan_all=scan_all)
    jdb = JaxVectorDB("ivf_pq", **kw).load(corpus)
    state = {key: np.asarray(v) for key, v in jdb.index.state_dict().items()}
    db = VectorDB("ivf_pq", device="cpu", **kw).load_state(
        from_reference_state(state))
    for raw in (False, True):
        assert db.index.memory_bytes(include_raw=raw) == \
            jdb.index.memory_bytes(include_raw=raw)


def test_register_engine_as_the_reference(data):
    """``register_engine`` adds an engine class under a name: ``VectorDB``
    builds and serves it, as the reference's does (a ``FlatIndex``
    subclass registered in both packages answers as the reference's: ids
    equal, scores within 1e-5); a name never registered still raises."""
    from repro.core import ENGINES as REF_ENGINES
    from repro.core import register_engine as ref_register
    from repro.core.flat import FlatIndex as RefFlat
    from repro_torch.core import ENGINES, register_engine
    from repro_torch.core.flat import FlatIndex

    class Mine(FlatIndex):
        pass

    class RefMine(RefFlat):
        pass

    corpus, q = data
    try:
        register_engine("mine", Mine)
        ref_register("mine", RefMine)
        db = VectorDB("mine", metric="l2", device="cpu").load(corpus)
        assert isinstance(db.index, Mine)
        s, i = db.query(q, k=5)
        rs, ri = JaxVectorDB("mine", metric="l2").load(corpus).query(q, k=5)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
        np.testing.assert_allclose(s.numpy(), np.asarray(rs), **TOL)
    finally:
        ENGINES.pop("mine", None)
        REF_ENGINES.pop("mine", None)
    with pytest.raises(KeyError, match="unknown engine"):
        VectorDB("mine", device="cpu")
