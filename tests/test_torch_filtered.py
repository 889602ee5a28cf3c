"""Filtered and hybrid search in the port (``repro_torch.search``,
``VectorDB.query(where=..., hybrid=...)``) against the reference, on the
CPU.

The patterns of tests/test_filtered.py: the predicate fuzz against a row
oracle (a plain seeded helper; a hypothesis variant calls the same
helper, not ``.__wrapped__``), the predicate edges, and the column writes
of the port's bulk path against the reference's row loop, leaf for leaf.
Filtered top-k from one trained state (the reference trains, the state and
its metadata leaves cross through ``convert.from_reference_state``) for
``flat``, ``int8``, ``ivf``, ``pq`` and ``ivf_pq`` under every
``adc_mode`` and ``scan_all``,
at about 1, 10 and 50 % selectivity and a compound predicate: ids exact
but between scores equal within the bound, scores within the ROADMAP's
float32 bound (atol = rtol = 1e-5), every id inside the bitmap. An
all-true predicate gives the unfiltered answer bit for bit. Then the
refusals (``lsh``, ``graph``), filtered
queries after writes, the nprobe boost and ``filter_stats``, metadata
through snapshots and the WAL, BM25 (postings, idf, lengths, scores) and
``hybrid_merge`` against the reference's, hybrid queries, both serving
fronts grouping filtered reads, and the plan ledger's filter salt.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import repro.search as R  # noqa: E402
from repro.core import VectorDB as JaxVectorDB  # noqa: E402
from repro.data.marco import MarcoLike  # noqa: E402

from repro_torch import VectorDB  # noqa: E402
from repro_torch.core.convert import from_reference_state  # noqa: E402
from repro_torch.search import (And, BM25Index, Eq, In,  # noqa: E402
                                MetadataStore, Not, Or, Range, filter_hash,
                                hybrid_merge)
from repro_torch.search.meta import Column  # noqa: E402
from test_torch_int8 import int8_ref_state  # noqa: E402
from test_torch_ivf import ivf_ref_state  # noqa: E402
from test_torch_mutation import _assert_same  # noqa: E402

SEED = 1234
CATS = ["x", "y", "z", "w"]
TOL = dict(atol=1e-5, rtol=1e-5)
PORT = {"Eq": Eq, "Range": Range, "In": In, "And": And, "Or": Or, "Not": Not}
REF = {"Eq": R.Eq, "Range": R.Range, "In": R.In, "And": R.And, "Or": R.Or,
       "Not": R.Not}


# --------------------------------------------------------------- fuzz oracle
def _random_rows(rng, n):
    """Row dicts over a fixed schema with about 30 % of the fields absent."""
    rows = []
    for _ in range(n):
        r = {}
        if rng.random() < 0.7:
            r["i"] = int(rng.integers(0, 6))
        if rng.random() < 0.7:
            r["f"] = float(rng.integers(0, 12)) / 2.0
        if rng.random() < 0.7:
            r["b"] = bool(rng.integers(0, 2))
        if rng.random() < 0.7:
            r["c"] = CATS[rng.integers(0, len(CATS))]
        rows.append(r)
    return rows


def _random_spec(rng, depth=0):
    """A predicate as a (name, args) tree, built in either package by
    ``_build``."""
    kind = rng.integers(0, 6 if depth < 3 else 3)
    if kind == 0:
        col = ["i", "f", "b", "c"][rng.integers(0, 4)]
        value = {"c": lambda: CATS[rng.integers(0, len(CATS))],
                 "b": lambda: bool(rng.integers(0, 2)),
                 "i": lambda: int(rng.integers(0, 6)),
                 "f": lambda: float(rng.integers(0, 12)) / 2.0}[col]()
        return ("Eq", col, value)
    if kind == 1:
        col = ["i", "f"][rng.integers(0, 2)]
        lo = None if rng.random() < 0.3 else float(rng.integers(0, 6))
        hi = None if rng.random() < 0.3 else float(rng.integers(0, 6))
        return ("Range", col, lo, hi)
    if kind == 2:
        col = ["i", "c"][rng.integers(0, 2)]
        if col == "c":
            vals = [CATS[j] for j in rng.integers(0, len(CATS), size=2)]
        else:
            vals = [int(v) for v in rng.integers(0, 6, size=2)]
        return ("In", col, vals)
    if kind == 3:
        return ("Not", _random_spec(rng, depth + 1))
    sub = [_random_spec(rng, depth + 1) for _ in range(int(rng.integers(1, 4)))]
    return ("And" if kind == 4 else "Or",) + tuple(sub)


def _build(spec, ns):
    name = spec[0]
    if name in ("And", "Or"):
        return ns[name](*(_build(s, ns) for s in spec[1:]))
    if name == "Not":
        return ns["Not"](_build(spec[1], ns))
    return ns[name](*spec[1:])


def _oracle(spec, rows):
    """Row-by-row evaluation of the predicate semantics."""
    def ev(p, r):
        name = p[0]
        if name == "Eq":
            return p[1] in r and r[p[1]] == p[2]
        if name == "Range":
            if p[1] not in r:
                return False
            v = r[p[1]]
            return (p[2] is None or v >= p[2]) and (p[3] is None or v <= p[3])
        if name == "In":
            return p[1] in r and r[p[1]] in p[2]
        if name == "Not":
            return not ev(p[1], r)
        if name == "And":
            return all(ev(c, r) for c in p[1:])
        return any(ev(c, r) for c in p[1:])
    return np.asarray([ev(spec, r) for r in rows], bool)


def _run_predicate_fuzz(seed: int):
    """The port's store against the row oracle and the reference's store,
    eight predicates over one seeded table."""
    rng = np.random.default_rng(SEED + seed)
    n = int(rng.integers(1, 80))
    rows = _random_rows(rng, n)
    store, ref = MetadataStore(), R.MetadataStore()
    store.put(np.arange(n), rows)
    ref.put(np.arange(n), rows)
    for _ in range(8):
        spec = _random_spec(rng)
        pred = _build(spec, PORT)
        assert filter_hash(pred) == R.filter_hash(_build(spec, REF))
        try:
            got = store.mask(pred, n)
        except TypeError:
            assert spec[0] == "Range"  # Range on a non-numeric column
            continue
        np.testing.assert_array_equal(got, _oracle(spec, rows),
                                      err_msg=repr(pred))
        np.testing.assert_array_equal(got, ref.mask(_build(spec, REF), n))


@pytest.mark.parametrize("seed", range(40))
def test_predicate_fuzz_vs_oracle(seed):
    _run_predicate_fuzz(seed)


def test_predicate_fuzz_hypothesis():
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st

    @given(seed=st.integers(0, 2 ** 16))
    @settings(max_examples=25, deadline=None)
    def run(seed):
        _run_predicate_fuzz(seed)

    run()


def test_predicate_semantics_edges():
    store = MetadataStore()
    store.put([0, 1, 2], [{"t": "a"}, {}, {"t": "b"}])
    np.testing.assert_array_equal(store.mask(Eq("t", "a"), 3),
                                  [True, False, False])
    np.testing.assert_array_equal(store.mask(~Eq("t", "a"), 3),
                                  [False, True, True])
    assert not store.mask(Eq("missing", 1), 3).any()
    assert not store.mask(In("t", ["zzz"]), 3).any()
    p = Eq("t", "a") | (Eq("t", "b") & ~In("t", ["c"]))
    assert store.mask(p, 3).tolist() == [True, False, True]
    assert filter_hash(None) == 0
    assert filter_hash(p) == filter_hash(
        Eq("t", "a") | (Eq("t", "b") & ~In("t", ["c"])))
    assert filter_hash(p) != filter_hash(Eq("t", "a"))
    with pytest.raises(TypeError):
        store.mask(Range("t", 0, 1), 3)  # Range needs a numeric column


@pytest.mark.parametrize("case", ["ints", "floats_from_ints", "bools", "cats",
                                  "cats_array", "with_none", "mixed_kinds",
                                  "repeated_ids", "rows"])
def test_bulk_column_writes_match_the_row_loop(case):
    """The port writes a batch of one kind in one numpy assignment; its
    leaves equal the reference's row loop's, codes in order of first
    appearance included, and a batch the loop refuses is refused."""
    rng = np.random.default_rng(3)
    n = 200
    ids = rng.permutation(400)[:n]
    meta = {"ints": {"v": [int(x) for x in rng.integers(-5, 5, n)]},
            "floats_from_ints": {"v": [1.5] + [int(x) for x in
                                               rng.integers(0, 9, n - 1)]},
            "bools": {"v": rng.integers(0, 2, n).astype(bool)},
            "cats": {"v": [CATS[j] for j in rng.integers(0, 4, n)]},
            "cats_array": {"v": np.asarray(CATS)[rng.integers(0, 4, n)]},
            "with_none": {"v": [None if j % 3 == 0 else int(j)
                                for j in range(n)]},
            "mixed_kinds": {"v": [1] * (n - 1) + [True]},
            "repeated_ids": {"v": list(range(n))},
            "rows": [{"a": int(j), "b": CATS[j % 4]} if j % 5 else {}
                     for j in range(n)]}[case]
    if case == "repeated_ids":
        ids = np.arange(n) % 50
    port, ref = MetadataStore(), R.MetadataStore()
    seed = {"ints": [1, 2, 3], "cats": ["z", "q", "x"]}.get(case)
    if seed is not None:  # a column that exists: its vocabulary continues
        port.put(np.arange(3), {"v": seed})
        ref.put(np.arange(3), {"v": seed})
    if case == "mixed_kinds":
        with pytest.raises(TypeError):
            port.put(ids, meta)
        return
    got = port.put(ids, meta)
    want = ref.put(ids, meta)
    assert got == {k: list(v) for k, v in want.items()}
    lp, lr = port.state_leaves(), ref.state_leaves()
    assert lp.keys() == lr.keys()
    for key in lp:
        np.testing.assert_array_equal(lp[key], lr[key], err_msg=key)


def test_column_refuses_a_wrong_kind():
    col = Column("int")
    with pytest.raises(TypeError, match="column holds 'int'"):
        col.set_rows(np.array([0, 1]), ["a", "b"])


# --------------------------------------------------- filtered top-k parity
N, D_, Q, K = 400, 16, 4, 10
IVF = dict(n_clusters=8, nprobe=2)
CONFIGS = [
    ("flat", "cosine", {}), ("flat", "l2", {}), ("flat", "dot", {}),
    ("pq", "cosine", {"refine": 0}), ("pq", "l2", {}),
    ("ivf_pq", "cosine", dict(IVF, refine=0, adc_mode="per_query")),
    ("ivf_pq", "cosine", dict(IVF, adc_mode="blocked")),
    ("ivf_pq", "l2", dict(IVF, refine=0, adc_mode="run_resident")),
    ("ivf_pq", "dot", dict(IVF, adc_mode="auto")),
    ("ivf_pq", "l2", dict(IVF, adc_mode="per_query")),
    ("ivf_pq", "cosine", dict(IVF, scan_all=True)),
    ("ivf_pq", "dot", dict(IVF, refine=0, scan_all=True)),
    ("int8", "cosine", {}), ("int8", "l2", {}), ("int8", "dot", {}),
    ("ivf", "cosine", dict(IVF)), ("ivf", "l2", dict(IVF)),
    ("ivf", "dot", dict(IVF)),
]


def _corpus(seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(N, D_)).astype(np.float32)
    meta = {"tag": (np.arange(N) % 100).tolist(),
            "name": [CATS[i % 4] for i in range(N)]}
    return X, meta


def _predicates(ns):
    """tag is uniform over 0..99: Eq about 1 %, Range(hi=9) 10 %,
    Range(hi=49) 50 %, and a compound one."""
    return [("1%", ns["Eq"]("tag", 7)), ("10%", ns["Range"]("tag", hi=9)),
            ("50%", ns["Range"]("tag", hi=49)),
            ("and", ns["And"](ns["Range"]("tag", hi=60),
                              ns["Not"](ns["Eq"]("name", "x"))))]


def _pair(engine, metric, kwargs):
    """The reference's engine and the port's from one trained state, both
    with the metadata."""
    X, meta = _corpus()
    jkw = dict(kwargs)
    if engine in ("pq", "ivf_pq"):
        jkw["use_kernel"] = False
    jdb = JaxVectorDB(engine, metric=metric, **jkw).load(X, meta=meta)
    if engine == "flat":
        idx = jdb.index
        state = {"engine": "flat", "metric": metric,
                 "corpus": idx._corpus.data[:N], "live": idx._valid.data[:N]}
        if idx._sq is not None:
            state["corpus_sq"] = idx._sq.data[:N]
    elif engine in ("ivf", "int8"):  # no state_dict: their attributes
        state = {"ivf": ivf_ref_state, "int8": int8_ref_state}[engine](
            jdb.index)
    else:
        state = {k: np.asarray(v) for k, v in jdb.index.state_dict().items()}
    state.update(jdb.metastore.state_leaves())
    db = VectorDB(engine, metric=metric, device="cpu", **kwargs).load_state(
        from_reference_state(state))
    return db, jdb, X


@pytest.mark.parametrize("engine,metric,kwargs", CONFIGS)
def test_filtered_topk_matches_the_reference(engine, metric, kwargs):
    db, jdb, X = _pair(engine, metric, kwargs)
    q = X[:Q] + 0.01
    for (label, pred), (_, jpred) in zip(_predicates(PORT), _predicates(REF)):
        got = db.query(q, k=K, where=pred)
        _assert_same(got, jdb.query(q, k=K, where=jpred), TOL)
        allowed = db.metastore.mask(pred, N)
        alive = got[1].numpy()
        assert allowed[alive[alive >= 0]].all(), label
    assert db.filter_stats["nprobe_boosts"] == jdb.filter_stats["nprobe_boosts"]
    assert (db.filter_stats["selectivity_hist"]
            == jdb.filter_stats["selectivity_hist"])


@pytest.mark.parametrize("engine,metric,kwargs", CONFIGS)
def test_all_true_bitmap_bit_identical(engine, metric, kwargs):
    db, _, X = _pair(engine, metric, kwargs)
    s0, i0 = db.query(X[:Q], k=K)
    s1, i1 = db.query(X[:Q], k=K, where=Range("tag", lo=0))
    assert torch.equal(i0, i1) and torch.equal(s0, s1)


def test_mask_allowed_ids_rewrites_only_the_filtered_slots():
    from repro_torch.kernels import ops
    ids = torch.tensor([[0, 3, -1, 7], [9, 2, 5, -1]], dtype=torch.int32)
    allowed = torch.tensor([True, False, True, True, False, True, False,
                            True])  # id 9 lies past the bitmap
    got = ops.mask_allowed_ids(ids, allowed)
    assert got.tolist() == [[0, 3, -1, 7], [-1, 2, 5, -1]]
    assert got.dtype == torch.int32
    assert torch.equal(ops.mask_allowed_ids(ids, torch.ones(10, dtype=torch.bool)),
                       ids)
    assert (ops.mask_allowed_ids(ids, torch.zeros(0, dtype=torch.bool))
            == -1).all()


def test_unfilterable_engines_refuse():
    """lsh and graph refuse a predicate, as in the reference; ivf and int8
    serve one."""
    X, meta = _corpus()
    for engine in ("lsh", "graph"):
        db = VectorDB(engine, device="cpu").load(X, meta=meta)
        with pytest.raises(NotImplementedError, match=engine):
            db.query(X[:2], k=4, where=Eq("tag", 1))
    for engine, kw in (("ivf", IVF), ("int8", {})):
        db = VectorDB(engine, device="cpu", **kw).load(X, meta=meta)
        s, i = db.query(X[:2], k=4, where=Eq("tag", 1))
        assert s.shape == (2, 4) and set(i[i >= 0].tolist()) <= \
            set(range(1, N, 100))
    with pytest.raises(TypeError, match="Predicate"):
        VectorDB("flat", device="cpu").load(X).query(X[:1], where={"tag": 1})


@pytest.mark.parametrize("engine,kwargs", [
    ("flat", {}), ("pq", {}), ("ivf_pq", dict(IVF, adc_mode="per_query")),
    ("ivf_pq", dict(IVF, scan_all=True))])
def test_filtered_after_mutation_matches_the_reference(engine, kwargs):
    """The bitmap covers the grown id space: writes with metadata keep the
    filters and the stable ids aligned in both packages."""
    metric = "dot" if kwargs.get("scan_all") else "l2"
    db, jdb, X = _pair(engine, metric, kwargs)
    rng = np.random.default_rng(3)
    new = rng.normal(size=(20, D_)).astype(np.float32)
    for d in (db, jdb):
        ids = d.insert(new, meta={"tag": [1000] * 20})
        d.delete(np.asarray(ids)[:5])
        d.upsert(new[5:7] * 0.5, np.asarray(ids)[5:7], meta={"tag": [2000] * 2})
        d.upsert(new[7:8], np.asarray(ids)[7:8])  # no meta: kept
    for jp, tp in ((R.Eq("tag", 1000), Eq("tag", 1000)),
                   (R.Eq("tag", 2000), Eq("tag", 2000))):
        _assert_same(db.query(X[:3], k=30, where=tp),
                     jdb.query(X[:3], k=30, where=jp), TOL)
    _, i = db.query(X[:3], k=30, where=Eq("tag", 1000))
    i = i.numpy()
    assert set(i[i >= 0].tolist()) == set(range(N + 7, N + 20))


def test_selectivity_nprobe_boost_and_stats():
    X, meta = _corpus()
    db = VectorDB("ivf_pq", metric="cosine", n_clusters=16, nprobe=2,
                  refine=0, device="cpu")
    db.load(X, meta=meta)
    assert db.filter_stats is None
    db.query(X[:2], k=5, where=Eq("tag", 7))       # about 1 %: boost 4
    db.query(X[:2], k=5, where=Range("tag", lo=0))  # all rows: none
    st = db.filter_stats
    assert st["filtered_batches"] == 2 and st["nprobe_boosts"] == 1
    assert st["selectivity_hist"]["<=1%"] == 1
    assert st["selectivity_hist"][">50%"] == 1
    assert st["bitmap_build_ms"] > 0


# ----------------------------------------------------------- durability
def test_metadata_snapshot_roundtrip(tmp_path):
    X, meta = _corpus()
    kw = dict(n_clusters=8, nprobe=8, refine=0)
    db = VectorDB("ivf_pq", metric="l2", device="cpu", **kw).load(X, meta=meta)
    db.save_index(str(tmp_path), 0)
    db2 = VectorDB("ivf_pq", metric="l2", device="cpu", **kw).restore_index(
        str(tmp_path))
    ref = JaxVectorDB("ivf_pq", metric="l2", use_kernel=False,
                      **kw).restore_index(str(tmp_path))
    for pred, jpred in ((Eq("name", "y"), R.Eq("name", "y")),
                        (Range("tag", hi=9) & ~Eq("name", "x"),
                         R.Range("tag", hi=9) & ~R.Eq("name", "x"))):
        s, i = db.query(X[:3], k=K, where=pred)
        s2, i2 = db2.query(X[:3], k=K, where=pred)
        assert torch.equal(i, i2) and torch.equal(s, s2)
        _assert_same((s, i), ref.query(X[:3], k=K, where=jpred), TOL)


def test_metadata_wal_recovery(tmp_path):
    rng = np.random.default_rng(5)
    X, meta = _corpus()
    kw = dict(n_clusters=8, nprobe=8, refine=0, device="cpu")
    db = VectorDB("ivf_pq", metric="l2", **kw).load(X, meta=meta)
    db.save_index(str(tmp_path), 0, durable=True)
    ins = db.insert(rng.normal(size=(12, D_)).astype(np.float32),
                    meta=[{"tag": 777, "src": "wal"}] * 12)
    db.delete(ins[:4])
    db.upsert(rng.normal(size=(3, D_)).astype(np.float32), ins[4:7],
              meta={"tag": [888] * 3, "src": ["up"] * 3})
    db.compact()
    db2 = VectorDB("ivf_pq", metric="l2", **kw).restore_index(str(tmp_path),
                                                              durable=True)
    for pred in (Eq("tag", 777), Eq("src", "up"),
                 Range("tag", hi=49) | Eq("tag", 888)):
        s, i = db.query(X[:3], k=K, where=pred)
        s2, i2 = db2.query(X[:3], k=K, where=pred)
        assert torch.equal(i, i2) and torch.equal(s, s2), repr(pred)
    db.wal.close()
    db2.wal.close()


def test_wal_meta_record_roundtrip(tmp_path):
    from repro_torch.core.wal import (WriteAheadLog, decode_payload,
                                      encode_record)
    meta = {"tag": [1, 2], "name": ["a", None]}
    rec = encode_record(7, "insert", vectors=np.zeros((2, 3), np.float32),
                        ids=np.asarray([5, 6]), meta=meta)
    got = decode_payload(rec[8:])
    assert got.meta == meta and got.lsn == 7
    bare = encode_record(7, "insert", vectors=np.zeros((2, 3), np.float32),
                         ids=np.asarray([5, 6]))
    assert b'"meta"' not in bare and decode_payload(bare[8:]).meta is None
    wal, _ = WriteAheadLog.open(str(tmp_path / "wal.log"))
    wal.append("insert", vectors=np.zeros((1, 2), np.float32),
               ids=np.asarray([0]), meta={"k": ["v"]})
    wal.append("delete", ids=np.asarray([0]))
    wal.truncate_through(0)  # rewrites every surviving record
    wal.close()
    wal2, records = WriteAheadLog.open(str(tmp_path / "wal.log"))
    wal2.close()
    assert [r.meta for r in records] == [{"k": ["v"]}, None]


def test_numpy_metadata_logs_as_json_scalars(tmp_path):
    """A numpy column (the bulk loader's form) logs as JSON scalars, which
    the reference's replay reads."""
    X, _ = _corpus()
    db = VectorDB("flat", metric="l2", device="cpu").load(X)
    db.save_index(str(tmp_path), 0, durable=True)
    db.insert(X[:3], meta={"tag": np.array([4, 5, 6]),
                           "name": np.array(["p", "q", "p"])})
    db.wal.close()
    from repro.core.wal import WriteAheadLog as JWal
    wal, records = JWal.open(str(tmp_path / "wal.log"))
    wal.close()
    assert records[0].meta == {"tag": [4, 5, 6], "name": ["p", "q", "p"]}


# ------------------------------------------------------------- BM25 + hybrid
def test_bm25_index_equals_the_reference():
    m = MarcoLike(n_passages=300, seed=4)
    texts = m.passage_texts()
    port = BM25Index.from_texts(texts)
    ref = R.BM25Index.from_texts(texts)
    assert port.n_docs == ref.n_docs and port.avgdl == ref.avgdl
    np.testing.assert_array_equal(port.doc_len, ref.doc_len)
    assert port.postings.keys() == ref.postings.keys()
    for t, (rows, tfs) in ref.postings.items():
        np.testing.assert_array_equal(port.postings[t][0], rows)
        np.testing.assert_array_equal(port.postings[t][1], tfs)
        assert port.idf[t] == ref.idf[t]
    ragged = [[3, 3, 9], [0, 1], [5, 9, 9, 2]]  # lists of ids, pads, unk
    a, b = BM25Index.from_tokens(ragged), R.BM25Index.from_tokens(ragged)
    assert a.postings.keys() == b.postings.keys() and a.idf == b.idf
    qt = port.tokenize(m.query_texts(noise=0.3)[:20])
    allowed = np.arange(300) % 3 != 0
    for al in (None, allowed):
        s, i = port.score(qt, k=15, allowed=al)
        s2, i2 = ref.score(qt, k=15, allowed=al)
        np.testing.assert_array_equal(i, i2)
        np.testing.assert_array_equal(s, s2)


@pytest.mark.parametrize("alpha", [0.0, 0.3, 0.5, 1.0])
def test_hybrid_merge_equals_the_reference(alpha):
    rng = np.random.default_rng(int(alpha * 10))
    Qn, k = 6, 8
    dense_i = np.stack([rng.permutation(30)[:k] for _ in range(Qn)])
    lex_i = np.stack([rng.permutation(30)[:k] for _ in range(Qn)])
    dense_i[0, 5:] = -1
    lex_i[1, :] = -1
    lex_i[2, 3:] = -1
    dense_s = np.sort(rng.normal(size=(Qn, k)), axis=1)[:, ::-1].copy()
    lex_s = np.sort(rng.gamma(2.0, size=(Qn, k)), axis=1)[:, ::-1].copy()
    dense_s[dense_i < 0] = -np.inf
    lex_s[lex_i < 0] = -np.inf
    lex_s[3] = 1.0  # a row of equal scores
    s, i = hybrid_merge(dense_s, dense_i, lex_s, lex_i, alpha=alpha, k=k)
    s2, i2 = R.hybrid_merge(dense_s, dense_i, lex_s, lex_i, alpha=alpha, k=k)
    np.testing.assert_array_equal(i, np.asarray(i2))
    np.testing.assert_array_equal(s, np.asarray(s2))
    assert s.dtype == np.float32 and i.dtype == np.int32


@pytest.mark.parametrize("engine,metric,kwargs", [
    ("flat", "cosine", {}), ("pq", "cosine", {}),
    ("ivf_pq", "cosine", dict(IVF, adc_mode="per_query")),
    ("ivf_pq", "dot", dict(IVF, scan_all=True))])
def test_hybrid_query_matches_the_reference(engine, metric, kwargs):
    """Hybrid answers (alone and with a predicate) equal the reference's
    from one trained state; alpha = 1 is the dense answer, alpha = 0
    BM25's ranking first."""
    db, jdb, X = _pair(engine, metric, kwargs)
    texts = MarcoLike(n_passages=N, seed=2).passage_texts()
    db.enable_lexical(texts)
    jdb.enable_lexical(texts)
    qt = MarcoLike(n_passages=N, seed=2).query_texts(noise=0.3)[:5]
    rng = np.random.default_rng(7)
    q = X[:5] + 0.3 * rng.normal(size=(5, D_)).astype(np.float32)
    for alpha in (0.0, 0.5, 1.0):
        for where, jwhere in ((None, None), (Eq("tag", 1), R.Eq("tag", 1))):
            got = db.query(q, k=7, hybrid=alpha, hybrid_texts=qt, where=where)
            want = jdb.query(q, k=7, hybrid=alpha, hybrid_texts=qt,
                             where=jwhere)
            _assert_same(got, want, TOL)
    dense = db.query(q, k=7)[1]
    assert torch.equal(db.query(q, k=7, hybrid=1.0, hybrid_texts=qt)[1], dense)
    lex_s, lex = db.lexical.score(db.lexical.tokenize(qt), k=7)
    got = db.query(q, k=7, hybrid=0.0, hybrid_texts=qt)[1].numpy()
    for r in range(5):
        # alpha 0: BM25's ranking first (ids may swap between equal BM25
        # scores); its lowest score normalizes to 0 and ties the dense-only
        # rows, which the merge puts first
        ok = lex[r] >= 0
        n_top = int((lex_s[r][ok] > lex_s[r][ok].min()).sum()) if ok.any() else 0
        score = dict(zip(lex[r][ok].tolist(), lex_s[r][ok].tolist()))
        assert [score.get(int(i)) for i in got[r, :n_top]] \
            == lex_s[r, :n_top].tolist()
    assert db.filter_stats["hybrid_merges"] == 8
    with pytest.raises(RuntimeError, match="enable_lexical"):
        VectorDB("flat", device="cpu").load(X).query(q, hybrid=0.5,
                                                      hybrid_texts=qt)


# ----------------------------------------------------------------- serving
def test_serve_fronts_group_and_match_direct():
    from repro_torch.serve import AsyncQueryEngine, QueryEngine
    X, meta = _corpus()
    pred = Range("tag", hi=9)

    def build():
        return VectorDB("flat", device="cpu").load(X, meta=meta)

    oracle = build()
    want = oracle.query(X[:6], k=5, where=pred)[1]
    plain = oracle.query(X[:6], k=5)[1]
    eng = QueryEngine(build(), max_batch=16)
    rids = [eng.submit(X[i], k=5, where=pred) for i in range(6)]
    rids += [eng.submit(X[i], k=5) for i in range(6)]
    eng.drain()
    for r, rid in enumerate(rids[:6]):
        assert torch.equal(eng.result(rid)[1], want[r])
    for r, rid in enumerate(rids[6:]):
        assert torch.equal(eng.result(rid)[1], plain[r])
    st = eng.latency_stats()
    assert st["filtered_batches"] >= 1 and "filter_sel_<=10%" in st
    with AsyncQueryEngine(build(), max_batch=16, max_wait_ms=1.0) as a:
        futs = [a.submit(X[i], k=5, where=pred) for i in range(6)]
        futs += [a.submit(X[i], k=5) for i in range(6)]
        got = [f.result(30) for f in futs]
    for r in range(6):
        assert torch.equal(got[r][1], want[r])
        assert torch.equal(got[6 + r][1], plain[r])


def test_filter_salts_plan_ledger():
    X, meta = _corpus()
    db = VectorDB("flat", device="cpu").load(X, meta=meta)
    db.query(X[:4], k=5)
    m0 = db.plan_stats["misses"]
    db.query(X[:4], k=5, where=Eq("tag", 1))
    assert db.plan_stats["misses"] == m0 + 1
    db.query(X[:4], k=5, where=Eq("tag", 1))
    assert db.plan_stats["misses"] == m0 + 1
    db.query(X[:4], k=5)
    assert db.plan_stats["misses"] == m0 + 1
    assert db._filter_ctx is None
