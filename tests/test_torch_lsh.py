"""The port's LSH engine and hamming kernel against the JAX package's, on
the CPU.

The plain Hamming versions equal the reference's oracle and its Pallas
kernel (interpret mode) exactly, on words drawn over the full 2^32 range;
the shortlist equals a stable argsort of the reference's distances, ties
included. Signatures cross frameworks except where a projection lies
within rounding of 0 (the two sum x . P in different orders), so search
parity loads the reference's planes and codes through
``core.convert.from_reference_state``: ids equal, f32 scores within
atol = rtol = 1e-5. The port's own planes are held to recall instead.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import VectorDB as JaxVectorDB  # noqa: E402
from repro.core import lsh as jlsh  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch import VectorDB  # noqa: E402
from repro_torch.core import lsh  # noqa: E402
from repro_torch.core.convert import from_reference_state  # noqa: E402
from repro_torch.kernels import hamming as H  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
METRICS = ["cosine", "l2", "dot"]
# (T, Q, N, W), the reference's HAMMING_CASES (tests/test_kernels.py)
HAMMING_CASES = [(1, 4, 256, 2), (3, 5, 700, 4), (8, 2, 128, 1), (2, 7, 1025, 8)]


def _words(rng, shape):
    """uint32 words over the full 2^32 range."""
    return rng.integers(0, 2 ** 32, size=shape, dtype=np.uint64).astype(np.uint32)


def _t(words):
    """uint32 numpy words -> the port's int32 bit patterns."""
    return torch.tensor(words.view(np.int32))


def _ref_distances(qc, cc):
    return np.asarray(jref.hamming_ref(jnp.asarray(qc), jnp.asarray(cc)))


@pytest.mark.parametrize("T,Q,N,W", HAMMING_CASES)
def test_hamming_plain_matches_reference(rng, T, Q, N, W):
    qc, cc = _words(rng, (T, Q, W)), _words(rng, (T, N, W))
    want = _ref_distances(qc, cc)
    kernel = np.asarray(jops.hamming(jnp.asarray(qc), jnp.asarray(cc),
                                     blk_n=128, interpret=True))
    np.testing.assert_array_equal(kernel, want)
    np.testing.assert_array_equal(H.hamming_plain(_t(qc), _t(cc)).numpy(), want)
    np.testing.assert_array_equal(ref.hamming_ref(_t(qc), _t(cc)).numpy(), want)
    np.testing.assert_array_equal(
        ops.hamming(_t(qc), _t(cc)).numpy(), want)


def test_hamming_sign_bit_words():
    """Words with the top bit set are negative int32s; no shift may smear
    the sign into the count."""
    edge = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF, 0xAAAAAAAA,
                     0x55555555, 0x80000001], dtype=np.uint32)
    cc = edge.reshape(1, -1, 1)
    qc = edge.reshape(1, -1, 1)
    want = _ref_distances(qc, cc)
    assert want[0, 4] == 32 and want[3, 4] == 31
    np.testing.assert_array_equal(H.hamming_plain(_t(qc), _t(cc)).numpy(), want)
    np.testing.assert_array_equal(
        H.popcount32(_t(edge)).numpy(),
        [0, 1, 31, 1, 32, 16, 16, 2])


def _stable_shortlist(dist, L):
    order = np.argsort(dist, axis=1, kind="stable")[:, :L]
    return np.take_along_axis(dist, order, 1), order


@pytest.mark.parametrize("L", [1, 10, 64])
@pytest.mark.parametrize("T,Q,N,W", HAMMING_CASES)
def test_hamming_shortlist_plain_matches_stable_argsort(rng, T, Q, N, W, L):
    qc, cc = _words(rng, (T, Q, W)), _words(rng, (T, N, W))
    want_d, want_i = _stable_shortlist(_ref_distances(qc, cc), L)
    for tile in (97, 1 << 16):  # the running merge across tiles, and none
        d, i = H.hamming_shortlist_plain(_t(qc), _t(cc), L, tile=tile)
        np.testing.assert_array_equal(d.numpy(), want_d)
        np.testing.assert_array_equal(i.numpy(), want_i)
        assert d.dtype == i.dtype == torch.int32


def test_hamming_shortlist_heavy_ties(rng):
    """Codes take four distinct values, so hundreds of rows share each
    distance: only the row-id order decides the shortlist."""
    T, W, N = 4, 4, 3000
    distinct = _words(rng, (T, 4, W))
    cc = distinct[:, rng.integers(0, 4, N)]
    qc = np.concatenate([distinct[:, :2], _words(rng, (T, 3, W))], axis=1)
    want_d, want_i = _stable_shortlist(_ref_distances(qc, cc), 200)
    d, i = ops.hamming_shortlist(_t(qc), _t(cc), 200)
    np.testing.assert_array_equal(d.numpy(), want_d)
    np.testing.assert_array_equal(i.numpy(), want_i)
    assert (np.diff(want_i[0][want_d[0] == 0]) > 0).all()


def test_hamming_shortlist_refuses_l_above_n(rng):
    qc, cc = _words(rng, (1, 2, 4)), _words(rng, (1, 5, 4))
    with pytest.raises(ValueError, match="L <= N = 5"):
        ops.hamming_shortlist(_t(qc), _t(cc), 6)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    centers = rng.normal(size=(12, 16)).astype(np.float32) * 2.0
    x = (centers[rng.integers(0, 12, 1200)]
         + rng.normal(size=(1200, 16)).astype(np.float32)) / np.float32(8.0)
    q = x[:9] + 0.1 / 8 * rng.normal(size=(9, 16)).astype(np.float32)
    return x, q


def test_sign_codes_match_reference_but_near_zero():
    """The reference's planes on the same rows give the same bits, except
    where the float64 projection is within 1e-5 of 0 (x . P summed in
    another order may round to the other sign there); such bits are rare."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2048, 64)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    planes = np.asarray(jlsh.make_planes(jax.random.PRNGKey(0), 64, 128, 4))
    want = np.asarray(jlsh.sign_codes(jnp.asarray(x), jnp.asarray(planes)))
    got = lsh.sign_codes(torch.tensor(x), torch.tensor(planes)).numpy()
    proj = np.einsum("nd,tdb->tnb", x.astype(np.float64), planes)   # 1M
    near = np.abs(proj) < 1e-5
    bits_got = (got.view(np.uint32)[..., None] >> np.arange(32)) & 1
    bits_want = (want[..., None] >> np.arange(32)) & 1
    differ = (bits_got != bits_want).reshape(near.shape)
    assert int(near.sum()) <= 40, int(near.sum())
    assert not (differ & ~near).any()
    assert got.dtype == np.int32 and got.shape == want.shape


def test_sign_codes_bit_order_and_chunking(monkeypatch):
    """Bit j of word w is plane 32 w + j, least significant first, with b
    not a multiple of 32; chunked rows give the whole pass's codes."""
    d, b = 8, 40
    planes = torch.zeros((1, d, b))
    planes[0, 0, :] = -1.0
    planes[0, 0, [0, 5, 31, 32, 39]] = 1.0      # x[0] > 0 sets these bits
    x = torch.zeros((3, d))
    x[:, 0] = torch.tensor([1.0, -1.0, 2.0])
    codes = lsh.sign_codes(x, planes)
    assert codes.shape == (1, 3, 2)
    assert codes[0, 0].tolist() == [(1 << 0) | (1 << 5) | -(1 << 31), 0b10000001]
    assert codes[0, 1].tolist() == [0x7FFFFFDE, 0x7E]
    rows = torch.randn((50, d), generator=torch.Generator().manual_seed(1))
    planes3 = torch.randn((3, d, b), generator=torch.Generator().manual_seed(2))
    whole = lsh.sign_codes(rows, planes3)
    monkeypatch.setattr(lsh, "PROJ_BUDGET", 3 * b * 7)        # 7 rows a chunk
    assert torch.equal(lsh.sign_codes(rows, planes3), whole)


def _reference_state(jdb):
    """The reference LSHIndex has no state_dict; its state is its planes,
    codes, corpus and |c|^2."""
    idx = jdb.index
    state = {"engine": "lsh", "metric": idx.metric,
             "shortlist": idx.shortlist, "planes": np.asarray(idx.planes),
             "codes": np.asarray(idx.codes), "corpus": np.asarray(idx.corpus)}
    if idx.corpus_sq is not None:
        state["corpus_sq"] = np.asarray(idx.corpus_sq)
    return state


@pytest.mark.parametrize("kw,k", [({}, 10), ({"shortlist": 5}, 10),
                                  ({"shortlist": 5000}, 10),
                                  ({"n_bits": 64, "n_tables": 2}, 7)],
                         ids=["default", "k_above_shortlist",
                              "shortlist_above_n", "w2"])
@pytest.mark.parametrize("metric", METRICS)
def test_lsh_from_reference_state_matches(data, metric, kw, k):
    corpus, q = data
    jdb = JaxVectorDB("lsh", metric=metric, **kw).load(corpus)
    state = from_reference_state(_reference_state(jdb))
    assert state["codes"].dtype == torch.int32
    db = VectorDB("lsh", metric=metric, device="cpu", **kw).load_state(state)
    ps, pi = db.query(q, k=k)
    rs, ri = (np.asarray(a) for a in jdb.query(q, k=k))
    np.testing.assert_array_equal(pi.numpy(), ri)
    np.testing.assert_allclose(ps.numpy(), rs, **TOL)
    assert pi.dtype == torch.int32 and ps.shape == (q.shape[0], k)
    if kw.get("shortlist") == 5:
        assert (pi[:, 5:] == -1).all() and torch.isneginf(ps[:, 5:]).all()


def test_lsh_search_and_distance_match_reference(data):
    """The functions under the engine: the reference's hamming_distance and
    lsh_search on the same state, without the front's plan ladder."""
    corpus, q = data
    jdb = JaxVectorDB("lsh", metric="l2").load(corpus)
    idx = jdb.index
    st = from_reference_state(_reference_state(jdb))
    q_codes_ref = jlsh.sign_codes(jnp.asarray(q), idx.planes)
    want = np.asarray(jlsh.hamming_distance(q_codes_ref, idx.codes))
    q_codes = lsh.sign_codes(torch.tensor(q), st["planes"])
    np.testing.assert_array_equal(
        lsh.hamming_distance(q_codes, st["codes"]).numpy(), want)
    rs, ri = jlsh.lsh_search(idx.corpus, idx.codes, idx.planes,
                             jnp.asarray(q), metric="l2", k=10, shortlist=32,
                             corpus_sq=idx.corpus_sq)
    ps, pi = lsh.lsh_search(st["corpus"], st["codes"], st["planes"],
                            torch.tensor(q), metric="l2", k=10, shortlist=32,
                            corpus_sq=st["corpus_sq"])
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ri))
    np.testing.assert_allclose(ps.numpy(), np.asarray(rs), **TOL)


def test_lsh_own_planes_recall(rng):
    """The reference's test_ann_recall_at_10 setting (1000 x 16, shortlist
    128, 8 tables) on the port's own planes, against the port's flat."""
    corpus = rng.normal(size=(1000, 16)).astype(np.float32)
    q = rng.normal(size=(20, 16)).astype(np.float32)
    _, eids = VectorDB("flat", device="cpu").load(corpus).query(q, k=10)
    db = VectorDB("lsh", shortlist=128, n_tables=8, device="cpu").load(corpus)
    _, ids = db.query(q, k=10)
    recall = np.mean([len(set(ids[i].tolist()) & set(eids[i].tolist())) / 10
                      for i in range(20)])
    assert recall >= 0.6, recall
    assert db.index.codes.shape == (8, 1000, 4)
    assert db.index.planes.shape == (8, 16, 128)


def test_lsh_state_round_trip(data):
    corpus, q = data
    db = VectorDB("lsh", metric="l2", n_bits=96, seed=3,
                  device="cpu").load(corpus)
    state = db.index.state_dict()
    back = VectorDB("lsh", metric="l2", device="cpu").load_state(state)
    assert (back.index.n_bits, back.index.n_tables) == (96, 4)
    assert back.index.codes.shape == (4, corpus.shape[0], 3)
    for a, b in zip(db.query(q, k=10), back.query(q, k=10)):
        assert torch.equal(a, b)
    assert db.index.memory_bytes() == (4 * 1200 * 3 + 4 * 16 * 96 + 1200) * 4
    assert db.index.memory_bytes(include_raw=True) == (
        db.index.memory_bytes() + corpus.size * 4)
    with pytest.raises(ValueError, match="metric"):
        VectorDB("lsh", metric="dot", device="cpu").load_state(state)


def test_lsh_seed_decides_the_planes(data):
    corpus, _ = data
    a = VectorDB("lsh", seed=1, device="cpu").load(corpus).index
    b = VectorDB("lsh", seed=1, device="cpu").load(corpus).index
    c = VectorDB("lsh", seed=2, device="cpu").load(corpus).index
    assert torch.equal(a.planes, b.planes) and torch.equal(a.codes, b.codes)
    assert not torch.equal(a.planes, c.planes)


def test_lsh_launches_nothing_on_cpu(data):
    corpus, q = data
    db = VectorDB("lsh", device="cpu").load(corpus)
    ops.reset_launch_counts()
    db.query(q, k=5)
    assert ops.launch_counts()["hamming"] == 0


@pytest.mark.parametrize("L", [1, 64, 256])
@pytest.mark.parametrize("T,W", [(4, 4), (8, 2), (1, 8), (4, 8), (1, 1)])
def test_hamming_shortlist_plan_fits_the_card_and_covers(T, W, L):
    """The shortlist kernel's launch plan, computed here from an H100's
    properties: every block fits 232,448 bytes of shared memory and, with
    the blocks an SM it counts, the SM's shared memory and registers; the
    query tiles (at most 16 queries up to Q = 64, 32 above, as even as Q
    allows) cover Q; the row chunks are whole 256-row tiles that cover N
    exactly once."""
    from repro_torch.kernels import _build
    card = _build.H100
    for N in (256, 300, 50_003, 262_144, 8_841_823):
        if L > N:
            continue
        for Q in (1, 2, 8, 9, 31, 32, 33, 100, 512):
            p = H.shortlist_plan(N, Q, T, W, L, card)
            assert set(p) == set(H.SHORTLIST_PLAN_KEYS)
            assert p["smem"] == H.shortlist_smem(p["qt"], L, T * W)
            assert p["smem"] <= 232_448
            assert p["blocks_per_sm"] * (p["smem"] + 1024) <= card["smem_sm"]
            assert p["blocks_per_sm"] * H.ROW_TILE * p["regs"] \
                <= card["regs_sm"]
            assert 1 <= p["qt"] <= H.MAX_QT
            q_tiles = -(-Q // p["qt"])
            assert (q_tiles - 1) * p["qt"] < Q <= q_tiles * p["qt"]
            cap = 16 if Q <= 64 else 32
            assert q_tiles == -(-Q // cap)
            rpc, nc = p["rows_per_chunk"], p["n_chunks"]
            assert rpc % H.ROW_TILE == 0 and 1 <= nc <= 65_535
            assert (nc - 1) * rpc < N <= nc * rpc
            assert 1 <= p["merge_groups"] <= max(1, -(-nc // 8))
