"""The port's int8 engine (``VectorDB("int8")``, ``core.quant``) against
the reference's, on the CPU.

``quantize_rows`` gives the reference's codes and scales on the same rows.
From the reference's codes, scales and |c|^2 (it has no ``state_dict``:
the state is a dict of its attributes) both packages answer the same
queries, unfiltered and under a predicate bitmap: ids exact but between
scores equal within the bound, scores within atol = rtol = 1e-5 (the
port scores q . (c_q * scale) where the reference scores (q . c_q) *
scale). The chunked scan (a tiny scratch budget) gives the one-chunk
answer; the score error against the float32 engine stays within the
reference's bound; writes and snapshots refuse.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402
import repro.search as R  # noqa: E402
from repro.core import VectorDB as JaxVectorDB  # noqa: E402
from repro.core.quant import quantize_rows as jax_quantize_rows  # noqa: E402

from repro_torch import VectorDB  # noqa: E402
from repro_torch.core import quant as QT  # noqa: E402
from repro_torch.core.convert import from_reference_state  # noqa: E402
from repro_torch.search import Eq, Range  # noqa: E402
from test_torch_engines import TOL  # noqa: E402
from test_torch_mutation import _assert_same  # noqa: E402

METRICS = ["cosine", "l2", "dot"]
N, D_ = 500, 32


def int8_ref_state(jidx) -> dict:
    """The reference Int8FlatIndex's state from its attributes."""
    state = {"engine": "int8", "metric": jidx.metric,
             "codes": np.asarray(jidx.codes), "scales": np.asarray(jidx.scales)}
    if jidx.corpus_sq is not None:
        state["corpus_sq"] = np.asarray(jidx.corpus_sq)
    return state


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(5)
    corpus = rng.normal(size=(N, D_)).astype(np.float32) / np.float32(
        np.sqrt(D_))
    q = corpus[:7] + 0.05 * rng.normal(size=(7, D_)).astype(np.float32)
    return corpus, q


def _pair(data, metric):
    corpus, _ = data
    jdb = JaxVectorDB("int8", metric=metric).load(corpus)
    db = VectorDB("int8", metric=metric, device="cpu").load_state(
        from_reference_state(int8_ref_state(jdb.index)))
    return db, jdb


def test_quantize_rows_equals_the_reference():
    """Codes and scales bit for bit on the same rows, a zero row (scale
    1e-12 / 127) and rows whose values round at .5 included."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(300, 48)).astype(np.float32) * 3.0
    x[0] = 0.0
    x[1] = np.linspace(-127, 127, 48, dtype=np.float32) / 2  # halves
    x[2, 0] = 127.0  # scale exactly 1
    x[2, 1:] = np.arange(47, dtype=np.float32) - 23.5
    codes, scales = QT.quantize_rows(torch.as_tensor(x))
    jc, js = jax_quantize_rows(jnp.asarray(x))
    assert codes.dtype == torch.int8 and scales.dtype == torch.float32
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(scales.numpy(), np.asarray(js))
    back = QT.dequantize_rows(codes, scales)
    assert float((back - torch.as_tensor(x)).abs().max()) <= \
        float(scales.max()) / 2 + 1e-6


@pytest.mark.parametrize("metric", METRICS)
def test_int8_load_matches_the_reference(data, metric):
    """The port's own load quantizes the rows it preprocesses as the
    reference does: the codes agree but for rows a normalization ulp
    moves across a rounding edge, and the answers agree."""
    corpus, q = data
    jdb = JaxVectorDB("int8", metric=metric).load(corpus)
    db = VectorDB("int8", metric=metric, device="cpu").load(corpus)
    diff = np.abs(db.index.codes.numpy().astype(int)
                  - np.asarray(jdb.index.codes).astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
    np.testing.assert_allclose(db.index.scales.numpy(),
                               np.asarray(jdb.index.scales), rtol=1e-6)
    _assert_same(db.query(q, k=10), jdb.query(q, k=10), dict(atol=1e-4,
                                                             rtol=1e-4))


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("k", [1, 10, 64])
def test_int8_from_reference_codes_matches(data, metric, k):
    _, q = data
    db, jdb = _pair(data, metric)
    _assert_same(db.query(q, k=k), jdb.query(q, k=k), TOL)


@pytest.mark.parametrize("metric", METRICS)
def test_int8_filtered_matches_the_reference(data, metric):
    """Under predicate bitmaps (about 1, 10 and 50 %) the answers agree
    with the reference's, every id inside the bitmap; an all-true filter
    is the unfiltered answer bit for bit."""
    _, q = data
    db, jdb = _pair(data, metric)
    meta = {"tag": (np.arange(N) % 100).tolist()}
    db.metastore.put(np.arange(N), meta)
    jdb.metastore.put(np.arange(N), meta)
    for port, ref in ((Eq("tag", 7), R.Eq("tag", 7)),
                      (Range("tag", hi=9), R.Range("tag", hi=9)),
                      (Range("tag", hi=49), R.Range("tag", hi=49))):
        got = db.query(q, k=10, where=port)
        _assert_same(got, jdb.query(q, k=10, where=ref), TOL)
        ids = got[1][got[1] >= 0].numpy()
        assert db.metastore.mask(port, N)[ids].all()
    # 5 rows pass Eq: the tail of each answer is (-inf, -1)
    s, i = db.query(q, k=10, where=Eq("tag", 7))
    assert bool(torch.isneginf(s[:, 5:]).all()) and bool((i[:, 5:] == -1).all())
    plain = db.query(q, k=10)
    every = db.query(q, k=10, where=Range("tag", lo=0))
    assert all(torch.equal(a, b) for a, b in zip(plain, every))
    assert db.filter_stats["nprobe_boosts"] == 0


@pytest.mark.parametrize("metric", METRICS)
def test_int8_chunked_scan_equals_one_chunk(data, metric, monkeypatch):
    """A scratch budget of 37 rows cuts the scan into 14 chunks; their
    merged top k is the one-chunk answer (ties to the lower id)."""
    _, q = data
    db, _ = _pair(data, metric)
    allowed = torch.as_tensor(np.arange(N) % 3 != 0)
    whole = [db.index.query(q, k=k, allowed=a) for k in (1, 10, 64)
             for a in (None, allowed)]
    monkeypatch.setattr(QT, "SCAN_BYTES", 37 * 4 * D_)
    assert QT.scan_rows(D_) == 37
    chunked = [db.index.query(q, k=k, allowed=a) for k in (1, 10, 64)
               for a in (None, allowed)]
    for (ws, wi), (cs, ci) in zip(whole, chunked):
        assert torch.equal(wi, ci) and torch.equal(ws, cs)


def test_int8_score_error_bounded():
    """The reference's test_int8_score_error_bounded on the port: per-row
    127-level quantization keeps every score within 5 % of the largest."""
    rng = np.random.default_rng(0)
    corpus = rng.normal(size=(200, 64)).astype(np.float32)
    q = rng.normal(size=(4, 64)).astype(np.float32)
    exact = VectorDB("flat", metric="dot", device="cpu").load(corpus)
    quant = VectorDB("int8", metric="dot", device="cpu").load(corpus)
    es, _ = exact.query(q, k=200)
    qs, _ = quant.query(q, k=200)
    scale = float(es.abs().max())
    assert float((torch.sort(qs).values - torch.sort(es).values).abs().max()) \
        < 0.05 * scale


def test_int8_refuses_writes_and_snapshots(data, tmp_path):
    corpus, _ = data
    db = VectorDB("int8", device="cpu").load(corpus)
    for op, args in (("insert", (corpus[:2],)), ("delete", ([1],)),
                     ("upsert", (corpus[:1], [0])), ("compact", ())):
        with pytest.raises(NotImplementedError,
                           match=f"engine 'int8' does not support {op}"):
            getattr(db, op)(*args)
    with pytest.raises(NotImplementedError, match="persistence"):
        db.save_index(str(tmp_path))
    assert db.n == N and db.index.memory_bytes() == N * D_ + N * 4
