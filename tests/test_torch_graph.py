"""The port's graph engine (``VectorDB("graph")``, ``core.graph``) against
the reference's, on the CPU.

The build draws its candidate samples with numpy from the same seed in
the same order in both packages, so the neighbor tables are equal array
for array: exact and at ``max_candidates=256, chunk=300``, and the
device ``_symmetrize`` equals the reference's numpy version on random
tables. ``beam_search`` from the reference's table (its attributes: it has
no ``state_dict``) gives the reference's answers, the engine end to end
gives them with no state carried over, the entry scan through
``topk_distance`` picks the seeds the reference's gather picks, and
filtered queries refuse.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402
from repro.core import VectorDB as JaxVectorDB  # noqa: E402
from repro.core import graph as JG  # noqa: E402

from repro_torch import VectorDB  # noqa: E402
from repro_torch.core import distances as DT  # noqa: E402
from repro_torch.core import graph as G  # noqa: E402
from repro_torch.core.convert import from_reference_state  # noqa: E402
from repro_torch.search import Eq  # noqa: E402
from test_torch_engines import BF16_TOL, TOL  # noqa: E402
from test_torch_mutation import _assert_same  # noqa: E402

METRICS = ["cosine", "l2", "dot"]


def graph_ref_state(jidx) -> dict:
    """The reference GraphIndex's state from its attributes (a bf16 corpus
    widened exactly to float32)."""
    state = {"engine": "graph", "metric": jidx.metric,
             "neighbors": np.asarray(jidx.neighbors),
             "corpus": np.asarray(jidx.corpus.astype(jnp.float32))}
    if jidx.corpus_sq is not None:
        state["corpus_sq"] = np.asarray(jidx.corpus_sq)
    return state


def _rows(seed, n, d=16):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x, rng


@pytest.mark.parametrize("metric", ["dot", "l2"])
@pytest.mark.parametrize("cap,chunk", [(None, 1024), (256, 300)])
def test_build_knn_graph_equals_the_reference(metric, cap, chunk):
    x, _ = _rows(1, 1200)
    kw = dict(degree=8, metric=metric, chunk=chunk, max_candidates=cap,
              seed=3)
    want = np.asarray(JG.build_knn_graph(jnp.asarray(x), **kw))
    stats = {}
    got = G.build_knn_graph(torch.as_tensor(x), stats=stats, **kw)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert stats["chunks"] == -(-1200 // chunk)
    assert stats["subsample"] == (cap is not None)


def test_build_pads_a_tiny_corpus_with_edge_repeats():
    x, _ = _rows(2, 6)
    want = np.asarray(JG.build_knn_graph(jnp.asarray(x), degree=8,
                                         metric="l2"))
    got = G.build_knn_graph(torch.as_tensor(x), degree=8, metric="l2")
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("n,deg", [(50, 8), (300, 16), (1000, 5)])
def test_symmetrize_equals_the_numpy_version(seed, n, deg):
    """Random tables, self-edges excluded as the build leaves them; skewed
    targets so that many rows pass the keep limit and many get none."""
    rng = np.random.default_rng(seed)
    hot = rng.integers(0, n, max(2, n // 10))
    nbrs = np.where(rng.random((n, deg)) < 0.6,
                    hot[rng.integers(0, hot.size, (n, deg))],
                    rng.integers(0, n, (n, deg)))
    own = np.arange(n)[:, None]
    nbrs = np.where(nbrs == own, (nbrs + 1) % n, nbrs).astype(np.int32)
    want = JG._symmetrize(nbrs, n)
    got = G._symmetrize(torch.as_tensor(nbrs), n)
    np.testing.assert_array_equal(got.numpy(), want)


def test_dedup_topk_equals_the_reference():
    rng = np.random.default_rng(4)
    ids = rng.integers(0, 30, (5, 40)).astype(np.int32)
    scores = rng.normal(size=(5, 40)).astype(np.float32)
    scores[:, ::7] = scores[:, :1]  # exact ties
    ji, js = JG._dedup_topk(jnp.asarray(ids), jnp.asarray(scores), 12)
    ti, ts = G._dedup_topk(torch.as_tensor(ids), torch.as_tensor(scores), 12)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def _pair(metric, dtype="float32", cap=16384, n=900, **kw):
    x, rng = _rows(7, n)
    q = x[:11] + 0.05 * rng.normal(size=(11, x.shape[1])).astype(np.float32)
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    kw = dict(kw, max_build_candidates=cap)
    jdb = JaxVectorDB("graph", metric=metric, dtype=jdt, **kw).load(x)
    return jdb, x, q, tdt, kw


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("metric", METRICS)
def test_beam_search_from_the_reference_table(metric, dtype):
    jdb, _, q, tdt, kw = _pair(metric, dtype, beam=16, n_hops=4,
                               entry_stride=16)
    db = VectorDB("graph", metric=metric, dtype=tdt, device="cpu",
                  **kw).load_state(from_reference_state(
                      graph_ref_state(jdb.index)))
    assert db.index.corpus.dtype == tdt and db.n == jdb.n
    tol = BF16_TOL[metric] if dtype == "bfloat16" else TOL
    for k in (1, 10, 20):  # 20 > beam: the tail is (-inf, -1)
        _assert_same(db.query(q, k=k), jdb.query(q, k=k), tol)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("cap", [None, 256])
def test_graph_engine_end_to_end_equals_the_reference(metric, cap):
    """No state crosses: the port builds its own graph from the vectors
    (the same table) and serves the reference's answers."""
    jdb, x, q, _, kw = _pair(metric, cap=cap)
    db = VectorDB("graph", metric=metric, device="cpu", **kw).load(x)
    np.testing.assert_array_equal(db.index.neighbors.numpy(),
                                  np.asarray(jdb.index.neighbors))
    assert db.index.build_stats["subsample"] == (cap is not None)
    for k in (1, 10):
        _assert_same(db.query(q, k=k), jdb.query(q, k=k), TOL)


@pytest.mark.parametrize("metric", ["dot", "l2"])
@pytest.mark.parametrize("stride", [1, 7, 64])
def test_entry_scan_equals_the_gather_version(metric, stride):
    """The seeds topk_distance picks over the contiguous entry rows are
    the ones the reference's formulation picks: every query gathers the
    strided rows, scores them and takes the top n_entry by position."""
    x, rng = _rows(9, 700)
    q = torch.as_tensor(rng.normal(size=(6, 16)).astype(np.float32))
    corpus = torch.as_tensor(x)
    sq = torch.sum(corpus * corpus, -1) if metric == "l2" else None
    rows, rows_sq = G.entry_rows(corpus, sq, stride)
    assert rows.is_contiguous() and rows.shape[0] == -(-700 // stride)
    from repro_torch.kernels import ops
    _, pos = ops.topk_distance(rows, q, k=4, metric=metric, corpus_sq=rows_sq)
    entry_ids = torch.arange(0, 700, stride)
    vecs = corpus[entry_ids[None].expand(6, -1)]
    dots = torch.einsum("qd,qcd->qc", q, vecs)
    scores = dots if metric == "dot" else -(
        torch.sum(q * q, -1)[:, None] - 2 * dots + sq[entry_ids][None])
    want = entry_ids[DT.topk_scores(scores, 4)[1]]
    assert torch.equal(pos.long() * stride, want)


def test_graph_refuses_filters_and_writes(tmp_path):
    x, _ = _rows(3, 200)
    db = VectorDB("graph", device="cpu").load(x, meta={"t": [1] * 200})
    with pytest.raises(NotImplementedError, match="graph"):
        db.query(x[:2], k=3, where=Eq("t", 1))
    with pytest.raises(NotImplementedError, match="does not support insert"):
        db.insert(x[:1])
    with pytest.raises(NotImplementedError, match="persistence"):
        db.save_index(str(tmp_path))
    # corpus, the neighbor table (degree 16) and the 4 entry rows
    assert db.index.memory_bytes() == (200 + 4) * 16 * 4 + 200 * 16 * 4
