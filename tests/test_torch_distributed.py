"""The port's mesh fronts (``repro_torch.core.distributed``,
``DistributedVectorDB``, ``DistributedPQ``, ``DistributedIVFPQ``) against
the reference's, on the CPU.

JAX fixes its device count when it starts, and a test worker may already
have it up with one device, so the reference's side runs in one
subprocess with eight host devices (as tests/test_distributed.py runs
it): it builds each engine on the meshes (1,), (4,) and (2, 4), answers
the same queries, takes a write sequence on ``DistributedIVFPQ``, runs
``two_level_search`` and the merge on planted ties, saves a checkpoint
with partition specs, and writes inputs, trained state
(``core.convert.mesh_leaves``) and outputs to npz files. The port then
serves each state on a mesh of the same shape made of the CPU repeated:
ids exact but between scores equal within the tolerance, scores within
atol = rtol = 1e-5 (bf16 and int8 LUTs within the ROADMAP's bounds), the
layout array for array after every write. Then the port's own pieces:
``make_mesh`` without a card, ``pad_to_shards``, the allocation policy's
free rows against the reference's layout (in-process: that layout is
numpy), both serving fronts over ``DistributedIVFPQ``, and the elastic
re-mesh restore across the packages both ways.
"""
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro_torch.core import (DistributedIVFPQ, DistributedPQ,  # noqa: E402
                              DistributedVectorDB)
from repro_torch.core import distributed as dist  # noqa: E402
from repro_torch.core.convert import from_reference_state  # noqa: E402
from repro_torch.core.ivf import BlockListLayout  # noqa: E402
from repro_torch import checkpoint as ckpt  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
TOL = dict(atol=1e-5, rtol=1e-5)
MESHES = {"1": ((1,), ("data",)), "4": ((4,), ("data",)),
          "2x4": ((2, 4), ("data", "model"))}
LAYOUT_ARRAYS = ("slots", "codes", "block_table", "bcnt", "tail_fill",
                 "block_cluster")
# (engine, name, constructor keywords) of every parity case; the reference
# script builds the same list, training once for cases that differ only in
# lut_dtype (the tables' type is a query-time choice)
CASES = ([("flat", f"flat_{m}", {"metric": m}) for m in ("cosine", "l2", "dot")]
         + [("flat", "flat_bf16", {"metric": "cosine", "dtype": "bfloat16"})]
         + [("pq", f"pq_{t}", {"metric": "cosine", "m": 8, "lut_dtype": t})
            for t in ("float32", "bfloat16", "int8")]
         + [("pq", f"pq_l2_{t}", {"metric": "l2", "m": 8, "lut_dtype": t})
            for t in ("float32", "bfloat16")]
         + [("ivf_pq", "ivf_pq_cosine", {"metric": "cosine", "nprobe": 8,
                                         "block_size": 8})]
         + [("ivf_pq", f"ivf_pq_l2_{t}", {"metric": "l2", "nprobe": 8,
                                          "block_size": 8, "lut_dtype": t})
            for t in ("float32", "int8")])
# every float32 case on every mesh, the bf16 and int8 tables on (4,): each
# case is one compile of the reference's program, most of the fixture's time
PARITY = [(mesh, case) for mesh in MESHES for case in CASES
          if mesh == "4" or case[2].get("lut_dtype", "float32") == "float32"]

REFERENCE = r'''
import copy, json, os, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro import checkpoint as rckpt
from repro.compat import shard_map
from repro.core import DistributedIVFPQ, DistributedPQ, DistributedVectorDB
from repro.core import distributed as rdist
from repro_torch.core.convert import mesh_leaves

out = sys.argv[1]
MESHES = json.loads(sys.argv[2])
PARITY = json.loads(sys.argv[3])


def save(name, leaves=None, **arrays):
    leaves = dict(leaves or {}, **arrays)
    bf16 = [k for k, v in leaves.items()
            if getattr(np.asarray(v), "dtype", None) is not None
            and np.asarray(v).dtype.name == "bfloat16"]
    leaves = {k: (np.asarray(v).view(np.uint16) if k in bf16 else
                  np.asarray(v)) for k, v in leaves.items()}
    np.savez(os.path.join(out, name + ".npz"), __bf16=np.asarray(bf16, str),
             **leaves)


def clustered(rng, n, d, c=30):
    """Rows of norm about 1, so that l2's |q|^2 - 2 q.c + |c|^2 loses no
    more than float32's rounding near 0."""
    centers = rng.normal(size=(c, d)).astype(np.float32) * 2.0
    return (centers[rng.integers(0, c, n)]
            + rng.normal(size=(n, d)).astype(np.float32)) / np.float32(
                2 * np.sqrt(d))


rng = np.random.default_rng(0)
corpus = clustered(rng, 1003, 32)
q = corpus[:12] + 0.002 * rng.normal(size=(12, 32)).astype(np.float32)
save("inputs", corpus=corpus, q=q)
ENGINES = {"flat": DistributedVectorDB, "pq": DistributedPQ,
           "ivf_pq": DistributedIVFPQ}
trained = {}
for mname, (engine, name, kw) in PARITY:
    shape, names = MESHES[mname]
    mesh = jax.make_mesh(tuple(shape), tuple(names))
    kw = dict(kw)
    if kw.get("dtype") == "bfloat16":
        kw["dtype"] = jnp.bfloat16
    if engine != "flat":
        kw["use_kernel"] = False
    lut = kw.pop("lut_dtype", "float32")
    key = (mname, engine, repr(sorted(kw.items())))
    if key not in trained:
        trained[key] = ENGINES[engine](mesh, **kw).load(corpus)
    db = copy.copy(trained[key])
    if engine != "flat":
        db.lut_dtype = lut
    s, i = db.query(q, k=10)
    sizes = {} if engine == "flat" else {"__pdb": db.per_device_bytes()}
    if engine == "pq":
        sizes["__mb"] = db.memory_bytes()
    save(f"{mname}_{name}", mesh_leaves(db), __s=s, __i=i, **sizes)
    if engine == "flat" and name == "flat_cosine" and len(shape) > 1:
        from repro.core import distances as D
        s2, i2 = rdist.sharded_flat_search(
            db.corpus, D.l2_normalize(jnp.asarray(q)), mesh=mesh, k=10,
            metric="dot", valid=db.valid, hierarchical=False)
        save(f"{mname}_flat_flatmerge", __s=s2, __i=i2)

# k above a shard's rows: 10 rows over 4 shards (3 a shard, 2 pad rows)
mesh4 = jax.make_mesh((4,), ("data",))
small = corpus[:10]
db = DistributedVectorDB(mesh4, metric="l2").load(small)
s, i = db.query(q[:3], k=8)
save("small", mesh_leaves(db), __s=s, __i=i)

# widths off the kernel's multiple of 8, on (2, 4), cosine and l2
mesh24 = jax.make_mesh((2, 4), ("data", "model"))
for d in (11, 50):
    wd = clustered(np.random.default_rng(d), 403, d)
    wq = wd[:7] + 0.002 * np.random.default_rng(d + 1).normal(
        size=(7, d)).astype(np.float32)
    for metric in ("cosine", "l2"):
        db = DistributedVectorDB(mesh24, metric=metric).load(wd)
        s, i = db.query(wq, k=10)
        save(f"width_{d}_{metric}", mesh_leaves(db), __s=s, __i=i, rows=wd,
             q=wq)

# two_level_search: queries over 'data', rows over 'model', n_valid
tl_c = rng.normal(size=(512, 16)).astype(np.float32)
tl_q = rng.normal(size=(8, 16)).astype(np.float32)
s, i = rdist.two_level_search(jnp.asarray(tl_c), jnp.asarray(tl_q),
                              mesh=mesh24, k=9, q_axes=("data",),
                              c_axes=("model",), tile=64, n_valid=500)
save("two_level", corpus=tl_c, q=tl_q, __s=s, __i=i)

# the merge on planted ties: scores from {0, 1, 2} (ties across shards and
# across both axes), k above each shard's k'
cand_s = rng.integers(0, 3, size=(8, 6, 5)).astype(np.float32)
cand_s[3, :, 4] = -np.inf
cand_i = (np.arange(8)[:, None, None] * 100
          + np.arange(5)[None, None, :] + 0 * cand_s).astype(np.int32)
axes = ("data", "model")
res = {}
for hier in (True, False):
    f = shard_map(
        lambda s_, i_: rdist._merge_local_topk(s_[0], i_[0], k=7, axes=axes,
                                               hierarchical=hier),
        mesh=mesh24, in_specs=(P(axes), P(axes)), out_specs=(P(), P()),
        check_replication=False)
    ms, mi = f(jnp.asarray(cand_s), jnp.asarray(cand_i))
    res[f"s_{hier}"], res[f"i_{hier}"] = ms, mi
save("ties", cand_s=cand_s, cand_i=cand_i, **res)

# writes on DistributedIVFPQ at (4,): spills, two growths that move the
# shard boundaries, tombstones, resurrecting upserts, compact
wr = np.random.default_rng(7)
wc = clustered(wr, 300, 16, c=6)
db = DistributedIVFPQ(mesh4, metric="cosine", n_clusters=6, nprobe=3, m=4,
                      ksub=16, kmeans_iters=4, block_size=8,
                      use_kernel=False).load(wc)
wq = wc[:9] + 0.002 * wr.normal(size=(9, 16)).astype(np.float32)
s, i = db.query(wq, k=10)
save("writes_0", mesh_leaves(db), __s=s, __i=i, corpus=wc, q=wq)
steps = [("insert", 200), ("delete", 80), ("upsert", 60), ("insert", 500),
         ("compact", 0), ("insert", 50)]
for n_step, (kind, n) in enumerate(steps, 1):
    vec = ids = None
    if kind == "insert":
        vec = clustered(wr, n, 16, c=6)
        got = np.asarray(db.insert(vec))
    elif kind == "delete":
        ids = np.concatenate([wr.integers(0, db.next_id, n), [-1, 10**6]])
        got = np.asarray(db.delete(ids))
    elif kind == "upsert":
        ids = wr.choice(db.next_id, n, replace=False)
        vec = clustered(wr, n, 16, c=6)
        got = np.asarray(db.upsert(vec, ids))
    else:
        got = np.asarray(json.dumps(db.compact()))
    s, i = db.query(wq, k=10)
    extra = {} if vec is None else {"vec": vec}
    if ids is not None:
        extra["ids"] = ids
    save(f"writes_{n_step}", mesh_leaves(db), __s=s, __i=i, kind=kind,
         got=got, capacity=db.layout.capacity, **extra)

# a checkpoint with partition specs from an 8-device mesh
mesh8 = jax.make_mesh((8,), ("data",))
codes = np.arange(64 * 3, dtype=np.int32).reshape(64, 3)
tree = {"index": {"codes": jax.device_put(
            codes, NamedSharding(mesh8, P("data", None))),
        "codebooks": np.linspace(0, 1, 12, dtype=np.float32).reshape(3, 4)},
        "step": np.asarray(5, np.int64)}
pspecs = {"index": {"codes": P("data", None), "codebooks": P()},
          "step": P()}
rckpt.save(tree, os.path.join(out, "ckpt"), 3, pspecs=pspecs)

# the port's snapshot of the same tree from 8 CPU shards, restored by the
# reference onto a 4-device mesh
import torch
from repro_torch import checkpoint as pckpt
from repro_torch.core import distributed as pdist
pmesh = pdist.make_mesh((8,), ("data",), devices=["cpu"] * 8)
placed = pdist.corpus_sharding(pmesh).place(torch.as_tensor(codes))
pckpt.save({"index": {"codes": placed.gather(),
                      "codebooks": torch.as_tensor(tree["index"]["codebooks"])},
            "step": tree["step"]}, os.path.join(out, "port_ckpt"), 3,
           pspecs={"index": {"codes": placed.sharding.spec,
                             "codebooks": pdist.P()}, "step": pdist.P()})
mesh4d = jax.make_mesh((4,), ("data",))
like = {"index": {"codes": np.zeros_like(codes),
                  "codebooks": np.zeros((3, 4), np.float32)},
        "step": np.asarray(0, np.int64)}
got = rckpt.restore_resharded(
    like, os.path.join(out, "port_ckpt"), 3, mesh4d,
    lambda key, leaf: NamedSharding(mesh4d, P("data", None)
                                    if key == "index/codes" else P()))
restored = got["index"]["codes"]
save("port_ckpt_restored", codes=restored, n_shards=len(
    restored.addressable_shards), slab=restored.addressable_shards[1].data,
     codebooks=got["index"]["codebooks"], step=got["step"])
print("OK")
'''


def _run_reference(code, *args):
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code, *args], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, (out.stdout[-2000:], out.stderr[-4000:])
    assert out.stdout.strip().endswith("OK")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's side, run once: {name: {leaf: array}}."""
    out = tmp_path_factory.mktemp("reference_mesh")
    _run_reference(REFERENCE, str(out), json.dumps(MESHES), json.dumps(PARITY))

    def load(name):
        with np.load(out / f"{name}.npz") as z:
            arrays = {k: z[k] for k in z.files}
        for key in arrays.pop("__bf16").tolist():
            import ml_dtypes
            arrays[key] = arrays[key].view(ml_dtypes.bfloat16)
        return arrays

    load.dir = out
    return load


def _mesh(name):
    shape, names = MESHES[name]
    return dist.make_mesh(shape, names, devices=["cpu"] * 8)


def _state(arrays):
    return from_reference_state({k: v for k, v in arrays.items()
                                 if not k.startswith("__")})


def _assert_same(got, want, tol):
    """Scores rank by rank within tol; ids equal but where two rows' scores
    agree within it. Slots past the live candidates are (-inf, -1) in the
    port; the reference keeps a knocked-out row's id there."""
    ps, pi = got[0].float().numpy(), got[1].numpy()
    rs, ri = np.asarray(want[0], np.float32), np.asarray(want[1])
    assert ps.shape == rs.shape, (ps.shape, rs.shape)
    np.testing.assert_allclose(ps, rs, **tol)
    dead = np.isneginf(rs)
    assert (pi[dead] == -1).all()
    for r, j in zip(*np.nonzero((pi != ri) & ~dead)):
        t = tol["atol"] + tol["rtol"] * abs(ps[r, j])
        where = np.flatnonzero(ri[r] == pi[r, j])
        other = rs[r, where[0]] if where.size else rs[r, -1]
        assert abs(other - ps[r, j]) <= t, (r, j, pi[r], ri[r])


def _lut_tol(db, q, lut_dtype):
    """The ROADMAP's LUT bounds from the port's own tables:
    bf16 m 2^-8 max|lut|, int8 m max|lut| / 254 (float32: the f32 bound)."""
    if lut_dtype == "float32":
        return TOL
    from repro_torch.core import distances as D
    from repro_torch.core.pq import adc_tables
    qq, metric = torch.as_tensor(q), db.metric
    if metric == "cosine":
        qq, metric = D.l2_normalize(qq), "dot"
    if metric == "l2" and hasattr(db, "centroids"):
        # IVF-PQ's l2 tables are built on q - centroid for each probe
        qq = (qq[:, None, :] - db.centroids[None]).reshape(-1, qq.shape[1])
    luts = adc_tables(db.codebooks, qq, metric=metric)
    m, top = luts.shape[1], float(luts.abs().max())
    bound = m * top * (2.0 ** -8 if lut_dtype == "bfloat16" else 1 / 254)
    return dict(atol=bound, rtol=1e-5)


# ----------------------------------------------------------------- parity
@pytest.mark.parametrize("mesh,case", PARITY,
                         ids=[f"{c[1]}-{m}" for m, c in PARITY])
def test_mesh_front_matches_the_reference(ref, mesh, case):
    """Each mesh front serving the reference engine's trained state on a
    mesh of the same shape: the reference's answers to the same queries."""
    engine, name, kw = case
    arrays = ref(f"{mesh}_{name}")
    q = ref("inputs")["q"]
    kw = dict(kw)
    cls = {"flat": DistributedVectorDB, "pq": DistributedPQ,
           "ivf_pq": DistributedIVFPQ}[engine]
    db = cls(_mesh(mesh), **kw).load_state(_state(arrays))
    assert db.n_shards == int(np.prod(MESHES[mesh][0]))
    got = db.query(q, k=10)
    assert got[1].dtype == torch.int64 and got[0].device.type == "cpu"
    tol = TOL
    if kw.get("dtype") == "bfloat16":
        # cosine queries normalized in bf16 on both sides, rounded in
        # different places (tests/test_torch_engines.py, BF16_TOL)
        tol = dict(atol=2.0 ** -7, rtol=0.0)
    elif engine != "flat":
        tol = _lut_tol(db, q, kw.get("lut_dtype", "float32"))
    _assert_same(got, (arrays["__s"], arrays["__i"]), tol)
    if engine != "flat":  # the reference's formulas on equal arrays
        assert db.per_device_bytes() == int(arrays["__pdb"])
    if engine == "pq":
        assert db.memory_bytes() == int(arrays["__mb"])
    if engine == "ivf_pq":
        for key in LAYOUT_ARRAYS:
            np.testing.assert_array_equal(
                getattr(db.layout, key).numpy(), arrays[f"layout_{key}"])
        slab = db.codes_bm.shards[0]
        assert slab.shape[0] == db.blocks_per_shard + 1
        assert slab.numel() <= db.codes_bm.numel() / db.n_shards


def test_flat_merge_without_the_inner_pre_merge(ref):
    """``hierarchical=False`` at (2, 4): one merge over all eight shards,
    the same answers as the reference's."""
    arrays = ref("2x4_flat_cosine")
    db = DistributedVectorDB(_mesh("2x4"), metric="cosine").load_state(
        _state(arrays))
    from repro_torch.core import distances as D
    q = D.l2_normalize(torch.as_tensor(ref("inputs")["q"]))
    got = dist.sharded_flat_search(db.corpus, q, mesh=db.mesh, k=10,
                                   metric="dot", valid=db.valid,
                                   hierarchical=False)
    want = ref("2x4_flat_flatmerge")
    _assert_same(got, (want["__s"], want["__i"]), TOL)
    _assert_same(db.query(ref("inputs")["q"], k=10), (want["__s"],
                                                      want["__i"]), TOL)


def test_k_above_the_rows_of_a_shard(ref):
    """10 rows over 4 shards (3 a shard, the last with 2 pad rows) at
    k = 8: each shard returns its 3 rows padded to k with (-inf, -1)
    before the merge, the pad rows never come back."""
    arrays = ref("small")
    db = DistributedVectorDB(_mesh("4"), metric="l2").load_state(
        _state(arrays))
    assert db.corpus.local_n == 3 and db.corpus.shape[0] == 12
    assert int(db.valid.shards[-1].sum()) == 1
    q = ref("inputs")["q"][:3]
    got = db.query(q, k=8)
    _assert_same(got, (arrays["__s"], arrays["__i"]), TOL)
    assert (got[1] < 10).all() and (got[1] >= 0).all()
    s, i = db.query(q, k=50)  # k past N: kk = N, as in the reference
    assert i.shape == (3, 10) and sorted(i[0].tolist()) == list(range(10))


@pytest.mark.parametrize("metric", ["cosine", "l2"])
@pytest.mark.parametrize("d", [11, 50])
def test_flat_mesh_front_at_any_width(ref, d, metric):
    """d = 11 and 50, off the kernel's multiple of 8, on (2, 4): the slabs
    padded with zero columns to 16 and 56 at ``load`` and at
    ``load_state`` (the reference's unpadded state), each query batch
    too; the reference's answers either way (ids exact but near-ties,
    scores within 1e-5)."""
    arrays = ref(f"width_{d}_{metric}")
    want = (arrays["__s"], arrays["__i"])
    for db in (DistributedVectorDB(_mesh("2x4"), metric=metric).load(
                   arrays["rows"]),
               DistributedVectorDB(_mesh("2x4"), metric=metric).load_state(
                   _state(arrays))):
        assert db.d == d
        assert all(c.shape[1] == d + (-d) % 8 for c in db.corpus.shards)
        _assert_same(db.query(arrays["q"], k=10), want, TOL)


def test_two_level_search_with_n_valid(ref):
    """Queries over 'data', rows over 'model', rows past n_valid knocked
    out: the reference's answers, and the port's flat scan's."""
    arrays = ref("two_level")
    c, q = torch.as_tensor(arrays["corpus"]), torch.as_tensor(arrays["q"])
    got = dist.two_level_search(c, q, mesh=_mesh("2x4"), k=9,
                                q_axes=("data",), c_axes=("model",),
                                n_valid=500)
    _assert_same(got, (arrays["__s"], arrays["__i"]), TOL)
    from repro_torch.core.flat import flat_search
    fs, fi = flat_search(c, q, metric="dot", k=9,
                         valid=torch.arange(512) < 500)
    assert torch.equal(got[1], fi.long())
    with pytest.raises(ValueError, match="overlap"):
        dist.two_level_search(c, q, mesh=_mesh("2x4"), k=9,
                              q_axes=("data",), c_axes=("data",))


@pytest.mark.parametrize("hierarchical", [True, False])
def test_merge_keeps_the_reference_tie_order(ref, hierarchical):
    """Scores from {0, 1, 2} on eight shards of a (2, 4) mesh, a shard with
    a -inf slot, k = 7 above each shard's 5: the reference's shard_map
    merge bit for bit, which is the order (score descending, shard, slot)."""
    arrays = ref("ties")
    cs, ci = arrays["cand_s"], arrays["cand_i"]
    parts = [(torch.as_tensor(cs[j]), torch.as_tensor(ci[j]).long())
             for j in range(8)]
    s, i = dist._merge_local_topk(parts, k=7, sizes=[2, 4],
                                  hierarchical=hierarchical,
                                  device=torch.device("cpu"))
    np.testing.assert_array_equal(s.numpy(), arrays[f"s_{hierarchical}"])
    np.testing.assert_array_equal(i.numpy(), arrays[f"i_{hierarchical}"])
    flat_s = np.moveaxis(cs, 0, 1).reshape(6, 40)
    flat_i = np.moveaxis(ci, 0, 1).reshape(6, 40)
    for r in range(6):
        order = np.lexsort((flat_i[r], -flat_s[r]))[:7]
        np.testing.assert_array_equal(i[r].numpy(), flat_i[r, order])
    ms, mi = dist.merge_candidate_sets(cs, ci, 7)
    np.testing.assert_array_equal(mi.numpy(), arrays["i_False"])


def test_writes_keep_the_layout_equal_to_the_reference(ref):
    """DistributedIVFPQ at (4,) from the reference's trained state takes
    the reference's writes (inserts that spill and grow the capacity twice,
    moving the shard boundaries; deletes with unknown ids; upserts that
    resurrect; compact): after each, the write's result, the layout array
    for array and its capacity, size, generation, the write counters and
    the answers."""
    first = ref("writes_0")
    db = DistributedIVFPQ(_mesh("4"), metric="cosine", nprobe=3).load_state(
        _state(first))
    q = first["q"]
    caps = {db.layout.capacity}
    for n_step in range(1, 7):
        want = ref(f"writes_{n_step}")
        kind = str(want["kind"])
        if kind == "insert":
            got = db.insert(want["vec"]).numpy()
        elif kind == "delete":
            got = db.delete(want["ids"])
        elif kind == "upsert":
            got = db.upsert(want["vec"], want["ids"]).numpy()
        else:
            got = json.dumps(db.compact())
        if kind == "compact":
            assert json.loads(got) == json.loads(str(want["got"]))
        else:
            np.testing.assert_array_equal(np.asarray(got), want["got"])
        for key in LAYOUT_ARRAYS:
            np.testing.assert_array_equal(
                getattr(db.layout, key).numpy(), want[f"layout_{key}"],
                err_msg=f"{kind} (step {n_step}): {key}")
        assert db.layout.capacity == int(want["capacity"])
        assert db.layout.capacity % 4 == 0
        caps.add(db.layout.capacity)
        np.testing.assert_array_equal(
            np.arange(db.layout.n_blocks, db.layout.capacity - 1),
            want["layout_free"])
        assert db.size == int((want["layout_pos"] >= 0).sum())
        assert db.generation == int(want["generation"])
        assert db.next_id == int(want["next_id"])
        for k2, v in db.mutation_stats.items():
            assert v == int(want[f"writes_{k2}"])
        assert db.blocks_per_shard == db.layout.capacity // 4
        _assert_same(db.query(q, k=10), (want["__s"], want["__i"]), TOL)
    assert len(caps) >= 3  # two growths moved the shard boundaries


def test_reference_checkpoint_restores_onto_a_smaller_mesh(ref):
    """The reference's snapshot from an 8-device mesh, partition specs in
    its manifest, placed on a port mesh of 4 by ``restore_resharded``."""
    path = str(ref.dir / "ckpt")
    with open(os.path.join(path, "step_00000003", "manifest.json")) as fh:
        leaves = json.load(fh)["leaves"]
    assert leaves["index/codes"]["pspec"] == ["data", None]
    assert leaves["index/codebooks"]["pspec"] == []
    mesh = dist.make_mesh((4,), ("data",), devices=["cpu"] * 4)
    like = {"index": {"codes": torch.zeros((64, 3), dtype=torch.int32),
                      "codebooks": torch.zeros((3, 4))},
            "step": torch.zeros((), dtype=torch.int64)}

    def sharding(key, leaf):
        return dist.NamedSharding(mesh, dist.P("data", None)
                                  if key == "index/codes" else dist.P())

    got = ckpt.restore_resharded(like, path, 3, mesh, sharding)
    codes = got["index"]["codes"]
    assert isinstance(codes, dist.ShardedRows) and len(codes.shards) == 4
    assert codes.local_n == 16
    np.testing.assert_array_equal(codes.gather().numpy(),
                                  np.arange(192).reshape(64, 3))
    np.testing.assert_allclose(got["index"]["codebooks"].numpy(),
                               np.linspace(0, 1, 12).reshape(3, 4), rtol=1e-6)
    assert int(got["step"]) == 5


def test_port_checkpoint_restores_onto_a_reference_mesh(ref):
    """The port's snapshot of a tree sharded over 8 CPU shards, with
    partition specs, restored by the reference's ``restore_resharded``
    onto a 4-device JAX mesh (in the reference's subprocess): the same
    values in 4 slabs, and the manifest the reference reads names the
    specs as the reference writes them."""
    path = ref.dir / "port_ckpt" / "step_00000003" / "manifest.json"
    leaves = json.loads(path.read_text())["leaves"]
    assert leaves["index/codes"]["pspec"] == [["data"], None]
    assert leaves["index/codebooks"]["pspec"] == []
    got = ref("port_ckpt_restored")
    np.testing.assert_array_equal(got["codes"],
                                  np.arange(192, dtype=np.int32).reshape(64, 3))
    assert int(got["n_shards"]) == 4 and got["slab"].shape == (16, 3)
    np.testing.assert_allclose(got["codebooks"],
                               np.linspace(0, 1, 12).reshape(3, 4), rtol=1e-6)
    assert int(got["step"]) == 5


# ------------------------------------------------------------ port pieces
def test_make_mesh_needs_the_cards_or_an_explicit_list(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA cards"):
        dist.make_mesh((2,), ("data",))
    mesh = dist.make_mesh((2, 2), ("data", "model"), devices=["cpu"] * 4)
    assert mesh.shape == {"data": 2, "model": 2}
    assert mesh.merge_device == torch.device("cpu") and mesh.size == 4
    assert mesh.shard_devices(("model",)) == [torch.device("cpu")] * 2
    with pytest.raises(ValueError, match="needs 4 devices"):
        dist.make_mesh((4,), ("data",), devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="not in mesh"):
        dist.corpus_sharding(mesh, ("pod",))


@pytest.mark.parametrize("N,S", [(10, 4), (12, 4), (1, 8), (7, 1), (0, 3)])
def test_pad_to_shards_rows(N, S):
    x = torch.arange(N * 2, dtype=torch.float32).reshape(N, 2) + 1
    padded, valid = dist.pad_to_shards(x, S)
    rows = -(-N // S) * S
    assert padded.shape == (rows, 2) and valid.shape == (rows,)
    assert int(valid.sum()) == N and bool(valid[:N].all())
    assert torch.equal(padded[:N], x) and not padded[N:].any()


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("S", [2, 3, 4])
def test_sharded_layout_matches_the_reference_policy(S, seed):
    """A layout with ``row_multiple=S`` against the reference's numpy
    layout under its mesh front's allocation policy (a block on the shard
    of its cluster's last block while that shard has a free row), through
    batches of inserts (spills, growths that move the shard boundaries),
    deletes and compactions: every array, the capacity, the free rows,
    which stay the one range the port keeps."""
    from repro.core.db import DistributedIVFPQ as RefDist
    from repro.core.ivf import BlockListLayout as RefLayout
    rng = np.random.default_rng(10 * S + seed)
    C, blk, m = 7, 8, 4
    assign = rng.integers(0, C, 200)
    codes = rng.integers(0, 256, (200, m)).astype(np.uint8)
    holder = types.SimpleNamespace(layout=None, n_shards=S)
    # the reference's from_assign, with the layout visible to the policy
    # from its first block (its mesh front sets it only after the build)
    refl = RefLayout(C, blk=blk, m=m, row_multiple=S,
                     alloc_policy=lambda c, free: RefDist._alloc_policy(
                         holder, c, free))
    holder.layout = refl
    refl._reserve_rows(int(-(-np.bincount(assign, minlength=C) // blk).sum())
                       + 2)
    order = np.argsort(assign, kind="stable")
    for c in range(C):
        sel = order[assign[order] == c]
        refl._bulk_append(c, sel, codes[sel])
    lay = BlockListLayout.from_assign(torch.as_tensor(assign), C, blk=blk,
                                      payload=torch.as_tensor(codes),
                                      row_multiple=S)
    nid, caps = 200, {lay.capacity}
    for step in range(60):
        op = "compact" if step % 25 == 24 else rng.choice(
            ["insert", "insert", "insert", "delete"])
        if op == "insert":
            n = int(rng.integers(1, 40))
            ids = np.arange(nid, nid + n)
            nid += n
            cl = (rng.integers(0, C, n) if rng.random() < 0.5
                  else np.full(n, rng.integers(0, C)))
            cd = rng.integers(0, 256, (n, m)).astype(np.uint8)
            refl.insert_rows(ids, cl, cd)
            lay.insert_rows(torch.as_tensor(ids), torch.as_tensor(cl),
                            torch.as_tensor(cd))
        elif op == "delete":
            ids = rng.integers(-2, nid + 3, 30)
            assert lay.delete_rows(torch.as_tensor(ids)) == refl.delete_rows(ids)
        else:
            assert lay.compact() == refl.compact()
        for key in LAYOUT_ARRAYS:
            np.testing.assert_array_equal(getattr(lay, key).numpy(),
                                          getattr(refl, key), err_msg=key)
        assert lay.capacity == refl.capacity and lay.capacity % S == 0
        assert lay.n_blocks == refl.n_blocks
        assert (lay.live, lay.tombstones) == (refl.live, refl.tombstones)
        assert sorted(refl._free) == list(range(lay.n_blocks,
                                                lay.capacity - 1))
        caps.add(lay.capacity)
    assert len(caps) > 1  # a growth moved the shard boundaries
    again = BlockListLayout.from_arrays(
        {"slots": lay.slots, "codes": lay.codes, "block_cluster":
         lay.block_cluster, "block_table": lay.block_table, "bcnt": lay.bcnt,
         "tail_fill": lay.tail_fill, "pos": lay.pos,
         "free": torch.arange(lay.n_blocks, lay.capacity - 1),
         "tombstones": lay.tombstones}, row_multiple=S)
    assert (again.n_blocks, again.live) == (lay.n_blocks, lay.live)
    with pytest.raises(ValueError, match="one range"):
        BlockListLayout.from_arrays(
            {"slots": lay.slots, "block_cluster": lay.block_cluster,
             "block_table": lay.block_table, "bcnt": lay.bcnt,
             "tail_fill": lay.tail_fill, "pos": lay.pos,
             "free": torch.arange(lay.n_blocks + 1, lay.capacity),
             "tombstones": lay.tombstones}, row_multiple=S)


@pytest.mark.parametrize("entry", ["front", "sharded_flat", "two_level"])
def test_tile_is_taken_at_the_reference_default_only(entry):
    """The reference's ``tile`` arguments: its default is taken (the same
    answers as without it), any other value is refused, since the kernels
    pick their own tiles."""
    mesh = _mesh_of(2)
    c = torch.as_tensor(np.random.default_rng(3).normal(size=(64, 8)),
                        dtype=torch.float32)
    q = c[:4] + 0.01
    if entry == "front":
        DistributedVectorDB(mesh, tile=65536)
        with pytest.raises(ValueError, match="tile=1024"):
            DistributedVectorDB(mesh, tile=1024)
        return
    fn, default = {"sharded_flat": (dist.sharded_flat_search, 65536),
                   "two_level": (dist.two_level_search, 4096)}[entry]
    kw = (dict(q_axes=(), c_axes=("data",)) if entry == "two_level"
          else dict(metric="dot"))
    got = fn(c, q, mesh=mesh, k=5, tile=default, **kw)
    want = fn(c, q, mesh=mesh, k=5, **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    with pytest.raises(ValueError, match="tile=64"):
        fn(c, q, mesh=mesh, k=5, tile=64, **kw)


def _mesh_of(S):
    return dist.make_mesh((S,), ("data",), devices=["cpu"] * S)


def test_both_fronts_serve_distributed_ivf_pq():
    """QueryEngine and AsyncQueryEngine over DistributedIVFPQ on a (4,)
    mesh, reads interleaved with inserts, deletes, an upsert and compact:
    every read equals ``db.query(bucketize=False)`` on a twin engine that
    applies the same writes in queue order, and writes route through
    ``apply_write``."""
    from repro_torch.serve import AsyncQueryEngine, QueryEngine
    rng = np.random.default_rng(3)
    centers = rng.normal(size=(6, 16)).astype(np.float32) * 2
    corpus = centers[rng.integers(0, 6, 400)] + rng.normal(
        size=(400, 16)).astype(np.float32)
    new = rng.normal(size=(40, 16)).astype(np.float32)
    qs = corpus[:36] + 0.05 * rng.normal(size=(36, 16)).astype(np.float32)
    kw = dict(metric="l2", n_clusters=6, nprobe=3, m=4, ksub=16,
              kmeans_iters=4, block_size=8)

    def script(submit, submit_write):
        out = []
        for i in range(36):
            if i % 9 == 2:
                out.append(("w", submit_write("insert", new[i:i + 5])))
            if i % 12 == 7:
                out.append(("w", submit_write("delete", ids=np.array(
                    [i, i + 1, 9999]))))
            if i == 20:
                out.append(("w", submit_write("upsert", new[:2],
                                              ids=np.array([3, 5]))))
            if i == 27:
                out.append(("w", submit_write("compact")))
            out.append(("r", submit(qs[i], 10)))
        return out

    oracle_db = DistributedIVFPQ(_mesh_of(4), **kw).load(corpus)
    oracle = script(lambda q, k: oracle_db.query(q, k=k, bucketize=False),
                    lambda kind, *a, **k2: oracle_db.apply_write(kind, *a, **k2))
    for front in ("pump", "async"):
        db = DistributedIVFPQ(_mesh_of(4), **kw).load(corpus)
        if front == "pump":
            eng = QueryEngine(db, max_batch=8, max_wait_ms=0.0)
            got = script(eng.submit, eng.submit_write)
            eng.drain()
            results = [eng.result(rid) for _, rid in got]
        else:
            eng = AsyncQueryEngine(db, max_batch=8, max_wait_ms=0.5)
            got = script(eng.submit, eng.submit_write)
            assert eng.drain(timeout=60)
            eng.close()
            results = [f.result(timeout=5) for _, f in got]
        assert db.mutation_stats["compactions"] == 1
        stats = eng.latency_stats()
        assert stats["engine"] == "dist_ivf_pq" and stats["write_inserts"] == 20
        for (kind, _), res, (_, want) in zip(got, results, oracle):
            if kind == "w":
                continue
            s, i = res
            np.testing.assert_array_equal(np.asarray(i), want[1][0].numpy())
            np.testing.assert_allclose(np.asarray(s), want[0][0].numpy(),
                                       atol=1e-5)


def test_fronts_serve_the_read_only_mesh_fronts():
    """QueryEngine over DistributedVectorDB and DistributedPQ: the answers
    of ``db.query(bucketize=False)``; a write to them is refused."""
    from repro_torch.serve import QueryEngine
    rng = np.random.default_rng(5)
    corpus = rng.normal(size=(300, 16)).astype(np.float32)
    qs = rng.normal(size=(10, 16)).astype(np.float32)
    mesh = _mesh("2x4")
    for db in (DistributedVectorDB(mesh, metric="dot").load(corpus),
               DistributedPQ(mesh, m=4, ksub=16, kmeans_iters=3).load(corpus)):
        eng = QueryEngine(db, max_batch=4, max_wait_ms=0.0)
        rids = [eng.submit(q, 5) for q in qs]
        eng.drain()
        want = db.query(qs, k=5, bucketize=False)
        for r, rid in enumerate(rids):
            np.testing.assert_array_equal(eng.result(rid)[1].numpy(),
                                          want[1][r].numpy())
        wid = eng.submit_write("insert", qs[:1])
        with pytest.raises(AttributeError):
            eng.drain()
        assert eng.result(wid) is None


def test_mesh_fronts_train_and_answer_as_the_single_host_engines():
    """One seed gives the mesh fronts the single-host engines' trained
    state (``PQIndex.load`` and ``IVFPQIndex.load`` step for step); a (1,)
    mesh, and rows sharded over one axis of a (2, 4) mesh, answer as the
    single-host engine, and ``DistributedIVFPQ``'s layout at (4,) equals
    ``IVFPQIndex``'s array for array (the owner policy takes the lowest
    free row, as the fast path does, and with four shards both round the
    capacity to the same power of two)."""
    from repro_torch import VectorDB
    rng = np.random.default_rng(8)
    centers = rng.normal(size=(12, 16)).astype(np.float32) * 2
    corpus = (centers[rng.integers(0, 12, 700)]
              + rng.normal(size=(700, 16)).astype(np.float32)) / 8
    q = corpus[:9] + 0.01
    kw = dict(m=4, ksub=16, kmeans_iters=4, seed=3)
    flat = VectorDB("flat", metric="l2", device="cpu").load(corpus)
    dflat = DistributedVectorDB(_mesh_of(1), metric="l2").load(corpus)
    for a, b in zip(dflat.query(q, k=7), flat.query(q, k=7)):
        assert torch.equal(a, b.to(a.dtype))
    # rows over one axis of a (2, 4) mesh: 4 slabs, replicated over 'data'
    part = DistributedVectorDB(_mesh("2x4"), metric="l2", axes=("model",))
    part.load(corpus)
    assert part.n_shards == 4 and part.corpus.local_n == 175
    s, i = part.query(q, k=7)
    want = flat.query(q, k=7)
    assert torch.equal(i, want[1].long())
    torch.testing.assert_close(s, want[0], **TOL)
    pq = VectorDB("pq", refine=0, device="cpu", **kw).load(corpus)
    dpq = DistributedPQ(_mesh_of(4), **kw).load(corpus)
    assert torch.equal(dpq.codebooks, pq.index.codebooks)
    assert torch.equal(dpq.codes.gather()[:700], pq.index.codes[:700])
    ivf = VectorDB("ivf_pq", refine=0, n_clusters=6, nprobe=3,
                   block_size=8, device="cpu", **kw).load(corpus)
    div = DistributedIVFPQ(_mesh_of(4), n_clusters=6, nprobe=3,
                           block_size=8, **kw).load(corpus)
    assert torch.equal(div.centroids, ivf.index.centroids)
    assert torch.equal(div.codebooks, ivf.index.codebooks)
    for key in LAYOUT_ARRAYS:
        assert torch.equal(getattr(div.layout, key),
                           getattr(ivf.index.layout, key)), key
    want = ivf.query(q, k=10, bucketize=False)
    got = div.query(q, k=10, bucketize=False)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1].to(got[1].dtype))


def test_mesh_fronts_keep_the_plan_ledger():
    """Batches pad to the plan ladder and count plan hits and misses per
    (engine, bucket, k, dtype, generation) key; ``bucketize=False``
    records nothing; a write that grows the layout bumps
    ``plan_generation``."""
    rng = np.random.default_rng(9)
    corpus = rng.normal(size=(300, 16)).astype(np.float32)
    db = DistributedIVFPQ(_mesh_of(2), n_clusters=4, nprobe=2, m=4,
                          ksub=16, kmeans_iters=3, block_size=8).load(corpus)
    q = corpus[:5]
    s5, i5 = db.query(q, k=4)
    db.query(q[:3], k=4)
    assert s5.shape == (5, 4) and db.plan_stats == {"hits": 0, "misses": 2}
    db.query(q[:4], k=4)
    assert db.plan_stats == {"hits": 1, "misses": 2}
    s, i = db.query(q, k=4, bucketize=False)
    assert db.plan_stats == {"hits": 1, "misses": 2}
    assert torch.equal(i, i5)
    gen = db.plan_generation
    db.insert(rng.normal(size=(400, 16)).astype(np.float32))
    assert db.plan_generation == gen + 1
    db.query(q[:4], k=4)
    assert db.plan_stats["misses"] == 3
    with pytest.raises(RuntimeError, match="before load"):
        DistributedPQ(_mesh_of(2)).query(q)
