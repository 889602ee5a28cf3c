"""The port's flat PQ path against the JAX package, on the CPU.

``pq_adc_plain`` (what the ``pq_adc`` wrapper runs on a CPU tensor) is held
against the reference's ``ref.pq_adc_ref`` oracle and its
``ops.adc_topk(use_kernel=False)`` twin on the same numpy inputs; the
``pq`` engine and IVF-PQ's ``scan_all`` path, loaded from the reference's
trained state, against the reference's engines. Tolerances as
``ROADMAP.md`` states them: float32 scores atol = rtol = 1e-5, ids exact
but for near-ties; a bf16 or int8 table is held to 1e-5 against the
reference using the same precision and to its quantization bound against
the float32 oracle (bf16 |d| <= m * 2^-8 * max|lut|, int8 |d| <= m *
max|lut| / 254).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from repro.core import VectorDB as JaxVectorDB  # noqa: E402
from repro.core import pq as jpq  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as R  # noqa: E402
from repro_torch import VectorDB  # noqa: E402
from repro_torch.core import pq as tpq  # noqa: E402
from repro_torch.core.convert import from_reference_state  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.pq_adc import pq_adc_plain  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
NEG_INF = -1e30


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _quant_bound(luts, lut_dtype, m):
    amax = float(np.abs(luts).max())
    return {"float32": 1e-5, "bfloat16": m * 2.0 ** -8 * amax,
            "int8": m * amax / 254}[lut_dtype]


def _assert_same(port, ref, tol=TOL):
    """Scores rank by rank within ``tol``; ids equal, except that two rows
    whose scores agree within ``tol`` may trade places."""
    (ps, pi), (rs, ri) = port, ref
    ps, pi = np.asarray(ps), np.asarray(pi)
    rs, ri = np.asarray(rs), np.asarray(ri)
    np.testing.assert_allclose(ps, rs, **tol)
    for r, j in zip(*np.nonzero(pi != ri)):
        t = tol["atol"] + tol["rtol"] * abs(ps[r, j])
        where = np.flatnonzero(ri[r] == pi[r, j])
        other = rs[r, where[0]] if where.size else rs[r, -1]
        assert abs(other - ps[r, j]) <= t, (r, j, pi[r], ri[r])


def _problem(rng, N, m, ksub, Q):
    codes = rng.integers(0, ksub, (N, m)).astype(np.uint8)
    luts = rng.normal(size=(Q, m, ksub)).astype(np.float32)
    return codes, luts


@pytest.mark.parametrize("lut_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("shape", [
    dict(N=700, m=8, ksub=32, Q=5, k=12),
    dict(N=3000, m=4, ksub=256, Q=3, k=64),
    dict(N=90, m=6, ksub=16, Q=4, k=90),
])
def test_adc_topk_plain_matches_reference(rng, lut_dtype, shape):
    """Ids equal to the reference's twin with the same table precision,
    scores within 1e-5, a third of the rows knocked out; against the
    float32 oracle within the precision's bound."""
    shape = dict(shape)
    k = shape.pop("k")
    codes, luts = _problem(rng, **shape)
    valid = rng.random(shape["N"]) >= 0.3
    ps, pi = ops.adc_topk(_t(codes), _t(luts), k=k, valid=_t(valid),
                          lut_dtype=lut_dtype)
    js, ji = jops.adc_topk(jnp.asarray(codes), jnp.asarray(luts), k=k,
                           valid=jnp.asarray(valid), use_kernel=False,
                           lut_dtype=lut_dtype)
    live = int(valid.sum())
    _assert_same((ps[:, :live].numpy(), pi[:, :live].numpy()),
                 (np.asarray(js)[:, :live], np.asarray(ji)[:, :live]))
    assert (pi[:, live:] == -1).all() and torch.isneginf(ps[:, live:]).all()
    assert valid[pi[pi >= 0].numpy()].all()
    bias = np.where(valid, 0.0, NEG_INF).astype(np.float32)
    rs, _ = R.pq_adc_ref(jnp.asarray(codes), jnp.asarray(luts), k=min(k, live),
                         bias=jnp.asarray(bias))
    rs = np.asarray(rs)
    got = ps[:, :rs.shape[1]].numpy()
    assert np.all(np.abs(got - rs) <= _quant_bound(luts, lut_dtype, shape["m"])
                  + 1e-5 * np.abs(rs))


@pytest.mark.parametrize("k", [1, 10, 57])
def test_pq_adc_plain_matches_ref_oracle(rng, k):
    """With a finite bias the plain version is the reference's oracle:
    score = sum_j lut[q, j, code_j] + bias[n], ids equal."""
    codes, luts = _problem(rng, N=1111, m=8, ksub=64, Q=6)
    bias = rng.normal(size=1111).astype(np.float32)
    ps, pi = pq_adc_plain(_t(codes), _t(luts), _t(bias), k=k, tile=100)
    rs, ri = R.pq_adc_ref(jnp.asarray(codes), jnp.asarray(luts), k=k,
                          bias=jnp.asarray(bias))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ri))
    np.testing.assert_allclose(ps.numpy(), np.asarray(rs), **TOL)


def test_pq_adc_oracles_agree(rng):
    """The port's materialize-everything oracle equals the reference's,
    with and without a bias."""
    from repro_torch.kernels import ref as TR
    codes, luts = _problem(rng, N=600, m=6, ksub=32, Q=4)
    bias = rng.normal(size=600).astype(np.float32)
    for b in (None, bias):
        ts, ti = TR.pq_adc_ref(_t(codes), _t(luts), k=25,
                               bias=None if b is None else _t(b))
        rs, ri = R.pq_adc_ref(jnp.asarray(codes), jnp.asarray(luts), k=25,
                              bias=None if b is None else jnp.asarray(b))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ri))
        np.testing.assert_allclose(ts.numpy(), np.asarray(rs), **TOL)


@pytest.mark.parametrize("tile", [7, 64, 1 << 15])
def test_pq_adc_duplicate_rows_tie_to_lower_id(rng, tile):
    """Duplicated code rows score equally; the lower row id comes first,
    as lax.top_k orders them, whether a tile splits the copies or not."""
    base, luts = _problem(rng, N=40, m=4, ksub=16, Q=3)
    codes = np.concatenate([base, base, base[:9]])
    s, i = pq_adc_plain(_t(codes), _t(luts), torch.zeros(codes.shape[0]),
                        k=30, tile=tile)
    rs, ri = R.pq_adc_ref(jnp.asarray(codes), jnp.asarray(luts), k=30)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(s.numpy(), np.asarray(rs))


@pytest.mark.parametrize("lut_dtype", ["float32", "bfloat16", "int8"])
def test_extra_code_column_equals_augmented_codes(rng, lut_dtype):
    """The extra int32 column (scan_all's cluster id, W > 256) scores as
    the reference's augmented (N, m+1) code table does."""
    N, m, ksub, C, Q = 800, 4, 32, 300, 5
    codes, _ = _problem(rng, N, m, ksub, Q)
    extra = rng.integers(0, C, N).astype(np.int32)
    luts = rng.normal(size=(Q, m + 1, C)).astype(np.float32)
    luts[:, :m, ksub:] = 0.0
    ps, pi = ops.adc_topk(_t(codes), _t(luts), k=20, extra_codes=_t(extra),
                          lut_dtype=lut_dtype)
    aug = np.concatenate([codes.astype(np.int32), extra[:, None]], axis=1)
    js, ji = jops.adc_topk(jnp.asarray(aug), jnp.asarray(luts), k=20,
                           use_kernel=False, lut_dtype=lut_dtype)
    _assert_same((ps, pi), (js, ji))


def test_pq_oracles_match_reference(rng):
    """pq_decode, adc_scores and pq_topk equal the reference's."""
    codebooks = rng.normal(size=(4, 16, 3)).astype(np.float32)
    codes, luts = _problem(rng, N=500, m=4, ksub=16, Q=3)
    np.testing.assert_array_equal(
        tpq.pq_decode(_t(codebooks), _t(codes), d=11).numpy(),
        np.asarray(jpq.pq_decode(jnp.asarray(codebooks), jnp.asarray(codes),
                                 d=11)))
    np.testing.assert_allclose(
        tpq.adc_scores(_t(luts), _t(codes)).numpy(),
        np.asarray(jpq.adc_scores(jnp.asarray(luts), jnp.asarray(codes))),
        **TOL)
    valid = rng.random(500) >= 0.2
    ts, ti = tpq.pq_topk(_t(luts), _t(codes), k=9, tile=128, valid=_t(valid))
    js, ji = jpq.pq_topk(jnp.asarray(luts), jnp.asarray(codes), k=9,
                         tile=128, valid=jnp.asarray(valid))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)
    ks, ki = ops.adc_topk(_t(codes), _t(luts), k=9, valid=_t(valid))
    np.testing.assert_array_equal(ki.numpy(), np.asarray(ji))


def _clustered(rng, n, d, n_clusters, scale=2.0):
    """Clusters at unit-order norms, so that l2's cancellation stays inside
    the 1e-5 tolerance."""
    centers = rng.normal(size=(n_clusters, d)).astype(np.float32) * scale
    x = (centers[rng.integers(0, n_clusters, n)]
         + rng.normal(size=(n, d)).astype(np.float32))
    return x / np.float32(2 * np.sqrt(d))


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    corpus = _clustered(rng, 1500, 16, 10)
    q = corpus[:7] + 0.1 * rng.normal(size=(7, 16)).astype(np.float32)
    return corpus, q


def _state(jdb):
    return from_reference_state(
        {key: np.asarray(v) for key, v in jdb.index.state_dict().items()})


@pytest.mark.parametrize("lut_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("metric", ["cosine", "l2", "dot"])
def test_pq_engine_from_reference_state_matches(data, metric, lut_dtype):
    """m = 8 subspaces of 64 codewords keep each row's code distinct, so ADC
    scores do not tie exactly: the reference's twin picks its top-k in two
    levels, which may order exactly tied rows either way, and a tie at the
    ``refine`` cut would then hand the re-rank another candidate. The tie
    order itself is held to ``ref.pq_adc_ref`` above."""
    corpus, q = data
    kw = dict(metric=metric, m=8, ksub=64, kmeans_iters=4,
              lut_dtype=lut_dtype)
    jdb = JaxVectorDB("pq", use_kernel=False, **kw).load(corpus)
    db = VectorDB("pq", device="cpu", **kw).load_state(_state(jdb))
    # the reference's count (codes, live mask, codebooks, |c|^2 for l2) at
    # the port's capacity: it adopts the loaded rows, where the reference
    # rounds its buffers up to a power of two
    n = corpus.shape[0]
    want = n * 8 + n + 8 * 64 * 2 * 4 + (n * 4 if metric == "l2" else 0)
    assert db.index.memory_bytes() == want
    for refine in (32, 0):
        jdb.index.refine = db.index.refine = refine
        tol = TOL if refine else _table_tol(db.index, q, lut_dtype)
        for k in (1, 10):
            _assert_same(db.query(q, k=k), jdb.query(q, k=k), tol)


def _table_tol(index, q, lut_dtype):
    """ADC scores against the reference's with a bf16 or int8 table: the
    two frameworks build the float32 table in different orders, so an entry
    can round to the neighbouring bf16 or int8 value; the documented
    quantization bound holds."""
    if lut_dtype == "float32":
        return TOL
    q = torch.as_tensor(q)
    metric = index.metric
    if metric == "cosine":
        q, metric = q / torch.linalg.vector_norm(q, dim=1, keepdim=True), "dot"
    luts = tpq.adc_tables(index.codebooks, q, metric=metric).numpy()
    return dict(atol=_quant_bound(luts, lut_dtype, luts.shape[1]), rtol=1e-5)


def test_pq_engine_own_training_recall():
    """The port trains its own codebooks; recall@10 against its own exact
    engine clears the reference CI's 0.8."""
    rng = np.random.default_rng(5)
    corpus = _clustered(rng, 3000, 32, 20)
    q = corpus[rng.choice(3000, 30, replace=False)] \
        + 0.05 * rng.normal(size=(30, 32)).astype(np.float32)
    _, truth = VectorDB("flat", device="cpu").load(corpus).query(q, k=10)
    db = VectorDB("pq", m=8, device="cpu").load(corpus)
    _, got = db.query(q, k=10)
    recall = np.mean([len(set(got[r].tolist()) & set(truth[r].tolist())) / 10
                      for r in range(len(q))])
    assert recall >= 0.8, recall


def test_pq_state_round_trip_and_dead_rows(data):
    """The port's own state loads back and answers the same; rows marked
    dead in the state never come back."""
    corpus, q = data
    db = VectorDB("pq", metric="l2", m=4, ksub=32, device="cpu").load(corpus)
    state = db.index.state_dict()
    assert {"codebooks", "codes", "live", "d", "corpus"} <= set(state)
    again = VectorDB("pq", metric="l2", device="cpu").load_state(state)
    for a, b in zip(db.query(q, k=10), again.query(q, k=10)):
        assert torch.equal(a, b)
    _, first = db.query(q, k=10)
    state = dict(state, live=state["live"].clone())
    state["live"][first[:, 0].long()] = False
    dead = VectorDB("pq", metric="l2", device="cpu").load_state(state)
    s, i = dead.query(q, k=10)
    assert not np.isin(i.numpy(), first[:, 0].numpy()).any()
    assert dead.index.size == corpus.shape[0] - len(set(first[:, 0].tolist()))


@pytest.mark.parametrize("lut_dtype", ["float32", "int8"])
@pytest.mark.parametrize("metric", ["cosine", "dot"])
def test_scan_all_from_reference_state_matches(data, metric, lut_dtype):
    """IVF-PQ's all-codes path: the coarse term folded in as an extra
    subspace as wide as the cluster count (here above ksub)."""
    corpus, q = data
    kw = dict(metric=metric, m=4, ksub=16, n_clusters=40, kmeans_iters=4,
              lut_dtype=lut_dtype, scan_all=True)
    jdb = JaxVectorDB("ivf_pq", use_kernel=False, **kw).load(corpus)
    db = VectorDB("ivf_pq", device="cpu", **kw).load_state(_state(jdb))
    assert db.index.codes.shape == (corpus.shape[0], 4)
    for refine in (32, 0):
        jdb.index.refine = db.index.refine = refine
        _assert_same(db.query(q, k=10), jdb.query(q, k=10))


def test_scan_all_refuses_l2(data):
    corpus, q = data
    db = VectorDB("ivf_pq", metric="l2", m=4, ksub=16, scan_all=True,
                  device="cpu").load(corpus)
    with pytest.raises(ValueError, match="scan_all"):
        db.query(q, k=3)


PLAN_NS = (1, 511, 512, 50_003, 262_144, 8_841_823)
PLAN_QS = (1, 2, 3, 5, 9, 32, 33, 100, 512)


@pytest.mark.parametrize("lut_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("k", [1, 32, 256])
@pytest.mark.parametrize("m,W,has_extra", [(8, 256, 0), (64, 256, 0),
                                           (7, 16, 0), (64, 2973, 1),
                                           (16, 3001, 1), (96, 256, 0)])
def test_pq_adc_plan_fits_the_card_and_covers(lut_dtype, k, m, W, has_extra):
    """The kernel's launch plan, computed here from an H100's properties:
    every block fits 232,448 bytes of shared memory and, with the blocks
    an SM it counts, the SM's shared memory and registers; the query tiles
    (kernel templates no larger than what fits) cover Q in as few tiles as
    fit; the row chunks are whole 512-row tiles that cover N exactly once,
    within the grid's 65,535 chunks."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import pq_adc as P
    card = _build.H100
    for N in PLAN_NS:
        for Q in PLAN_QS:
            p = P.plan(N, Q, m, W, k, lut_dtype, has_extra, card)
            assert set(p) == set(P.PLAN_KEYS)
            top = P.fit_qt(m, W, k, lut_dtype, has_extra, card)
            assert p["qt"] in P.QTS and p["qt"] <= top
            assert p["smem"] == P.smem_bytes(lut_dtype, p["qt"], m, has_extra,
                                              W, k, p["stages"])
            assert p["smem"] <= 232_448 and p["stages"] in (2, 3)
            assert p["blocks_per_sm"] * (p["smem"] + 1024) <= card["smem_sm"]
            assert p["blocks_per_sm"] * P.THREADS * p["regs"] \
                <= card["regs_sm"]
            assert p["regs"] >= 64
            q_tiles = -(-Q // p["qt"])
            assert (q_tiles - 1) * p["qt"] < Q <= q_tiles * p["qt"]
            assert q_tiles == -(-Q // top)  # as few tiles as fit
            rpc, nc = p["rows_per_chunk"], p["n_chunks"]
            assert rpc % P.TILE_ROWS == 0 and 1 <= nc <= 65_535
            assert (nc - 1) * rpc < N <= nc * rpc
            assert 1 <= p["merge_groups"] <= max(1, -(-nc // 8))


def test_pq_adc_plan_takes_the_fewest_query_tiles():
    """The plan takes as few query tiles as the largest tile that fits
    allows, each the smallest template that covers Q in that many, among
    the tiles whose tables fit; ``qt`` forces one, an unfit one is
    refused."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import pq_adc as P
    card = _build.H100
    assert P.fit_qt(64, 256, 32, "float32", 0, card) == 3
    assert P.fit_qt(64, 256, 32, "bfloat16", 0, card) == 4
    assert P.fit_qt(64, 256, 32, "int8", 0, card) == 8
    assert P.fit_qt(16, 256, 32, "int8", 0, card) == 12
    N = 8_841_823
    for Q, dt, qt in ((32, "float32", 3), (33, "float32", 3),
                      (4, "float32", 2), (512, "float32", 3),
                      (32, "bfloat16", 4), (5, "bfloat16", 3),
                      (32, "int8", 8), (9, "int8", 6), (1, "int8", 1)):
        assert P.plan(N, Q, 64, 256, 32, dt, 0, card)["qt"] == qt, (Q, dt)
    assert P.plan(N, 32, 64, 256, 32, "float32", 0, card, qt=2)["qt"] == 2
    with pytest.raises(ValueError, match="query tile 4"):
        P.plan(N, 32, 64, 256, 32, "float32", 0, card, qt=4)
