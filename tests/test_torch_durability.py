"""Durability in the port (``repro_torch.checkpoint``, ``core.wal``,
``ft.faults`` and the ``VectorDB`` side) on the CPU, against the reference.

The patterns of tests/test_wal.py and tests/test_checkpoint.py, on the
port: the WAL record round trip, torn and CRC-corrupt tails, group commit;
the crash matrix over every registered crash point (recovery serves the
answers of an uncrashed twin that took the surviving prefix of the
writes, bit for bit); replay by lsn after a crash between rename and
truncate; the lsn floor after a truncating snapshot; the snapshot cadence
by bytes and by age; partial and corrupt steps skipped; the async front
acknowledging a write only after its fsync; the checkpoint store
(retention, background saves and their retries, chunked and bf16 leaves,
partition specs in the reference's manifest form, the re-mesh restore);
the seeded crash-recovery fuzz against a dict oracle.

Then both directions across the packages: the record framing byte for
byte, and a snapshot plus a log written by one package restored by the
other (``flat`` float32 and bf16, ``pq``, ``ivf_pq``, with metadata
leaves and ``meta`` records), serving the same top-k: ids exact but
between scores equal within the bound, scores within the ROADMAP's
float32 bound (atol = rtol = 1e-5; the bf16 flat's cosine queries within
2^-7, as tests/test_torch_engines.py has it).
"""
import os
import shutil
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402
from repro import checkpoint as rckpt  # noqa: E402
from repro.core import VectorDB as JaxVectorDB  # noqa: E402
from repro.core import wal as rwal  # noqa: E402
from repro.ft import faults as rfaults  # noqa: E402
from repro.search import Eq as JEq, Range as JRange  # noqa: E402

from repro_torch import VectorDB  # noqa: E402
from repro_torch import checkpoint as ckpt  # noqa: E402
from repro_torch.checkpoint import CheckpointStore  # noqa: E402
from repro_torch.core.wal import (WriteAheadLog, decode_payload,  # noqa: E402
                                  encode_record)
from repro_torch.ft.faults import (CRASH_POINTS, SimulatedCrash,  # noqa: E402
                                   crashpoint, inject_crashes)
from repro_torch.search import Eq, Range  # noqa: E402
from repro_torch.serve import AsyncQueryEngine  # noqa: E402
from test_torch_mutation import _assert_same, _check_exact  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
BF16_COSINE_TOL = dict(atol=2.0 ** -7, rtol=0.0)
D = 8
# exhaustive config (nprobe = C, re-rank everything): the engine answers
# brute force over the live rows, so recovered against oracle is exact
KW = dict(n_clusters=4, nprobe=4, m=4, ksub=16, refine=4096, block_size=8,
          compact_threshold=0.5)


def _mk_db():
    return VectorDB("ivf_pq", metric="l2", device="cpu", **KW)


@pytest.fixture(scope="module")
def base_snapshot(tmp_path_factory):
    """One trained ivf_pq snapshot shared by the matrix."""
    rng = np.random.default_rng(7)
    corpus = rng.normal(size=(48, D)).astype(np.float32)
    base = tmp_path_factory.mktemp("wal_base")
    _mk_db().load(corpus).save_index(str(base), step=0)
    return str(base)


def _script(seed: int):
    """A write script over all four logged kinds."""
    rng = np.random.default_rng(seed)
    return [
        ("insert", rng.normal(size=(3, D)).astype(np.float32), None),
        ("delete", None, np.array([1, 5])),
        ("insert", rng.normal(size=(2, D)).astype(np.float32), None),
        ("upsert", rng.normal(size=(2, D)).astype(np.float32),
         np.array([2, 9])),
        ("compact", None, None),
        ("insert", rng.normal(size=(1, D)).astype(np.float32), None),
    ]


_SNAP_AT = 3  # save_index(durable) runs before script step 3


def _same_answers(a, b, q, k=5):
    s0, i0 = a.query(q, k=k)
    s1, i1 = b.query(q, k=k)
    assert torch.equal(i0, i1)
    assert torch.equal(s0, s1)


# ------------------------------------------------------------ WAL basics

def test_crash_points_equal_the_reference():
    assert CRASH_POINTS == rfaults.CRASH_POINTS


def test_wal_record_roundtrip():
    rec = decode_payload(encode_record(
        7, "upsert", torch.arange(6, dtype=torch.float32).reshape(2, 3),
        torch.tensor([4, 9]))[8:])
    assert rec.lsn == 7 and rec.kind == "upsert"
    assert rec.vectors.dtype == torch.float32 and rec.ids.dtype == torch.int64
    assert rec.vectors.reshape(-1).tolist() == list(range(6))
    none = decode_payload(encode_record(1, "compact")[8:])
    assert none.vectors is None and none.ids is None


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32", "int64"])
def test_wal_records_cross_the_packages_byte_for_byte(dtype):
    """The same write logged by either package is the same bytes, and each
    decodes the other's (bf16 as the reference's ml_dtypes bf16)."""
    x = np.linspace(-2, 2, 12, dtype=np.float32).reshape(3, 4)
    ids = np.array([5, 6, 9], dtype=np.int64)
    meta = {"tag": [1, 2, None], "src": ["a", "b", "c"]}
    if dtype == "bfloat16":
        tv = torch.from_numpy(x).bfloat16()
        jv = np.asarray(jnp.asarray(x).astype(jnp.bfloat16))
    else:
        tv = torch.from_numpy(x.astype(dtype))
        jv = x.astype(dtype)
    port = encode_record(3, "insert", tv, torch.from_numpy(ids), meta)
    ref = rwal.encode_record(3, "insert", jv, ids, meta)
    assert port == ref
    got = rwal.decode_payload(port[8:])
    assert str(got.vectors.dtype) == dtype and got.meta == meta
    np.testing.assert_array_equal(np.asarray(got.vectors, np.float32),
                                  tv.float().numpy())
    back = decode_payload(ref[8:])
    assert str(back.vectors.dtype) == f"torch.{dtype}"
    assert torch.equal(back.vectors, tv) and back.ids.tolist() == [5, 6, 9]


def test_wal_append_reopen_replay(tmp_path):
    path = str(tmp_path / "wal.log")
    wal, records = WriteAheadLog.open(path)
    assert records == []
    wal.append("insert", np.ones((2, 3), np.float32), np.arange(2))
    wal.append("delete", ids=torch.tensor([0]))
    wal.close()
    wal2, records = WriteAheadLog.open(path)
    assert [r.lsn for r in records] == [1, 2]
    assert wal2.last_lsn == 2
    wal2.close()
    # after_lsn filters what a snapshot already covers
    wal3, tail = WriteAheadLog.open(path, after_lsn=1)
    assert [r.lsn for r in tail] == [2]
    wal3.close()
    # the counters floor at after_lsn even on an empty log
    wal4, none = WriteAheadLog.open(str(tmp_path / "empty.log"), after_lsn=7)
    assert none == [] and wal4.last_lsn == wal4.synced_lsn == 7
    wal4.close()


def test_wal_torn_tail_truncated_not_raised(tmp_path):
    path = str(tmp_path / "wal.log")
    wal, _ = WriteAheadLog.open(path)
    for i in range(3):
        wal.append("insert", np.full((1, 2), i, np.float32), np.array([i]))
    wal.close()
    good_size = os.path.getsize(path)
    with open(path, "ab") as fh:  # a torn append: half a frame
        fh.write(b"\x13\x00\x00\x00TORNTORN")
    wal2, records = WriteAheadLog.open(path)
    assert [r.lsn for r in records] == [1, 2, 3]
    assert wal2.truncated_bytes == 12
    assert os.path.getsize(path) == good_size
    wal2.append("delete", ids=np.array([1]))
    wal2.close()
    _, records = WriteAheadLog.open(path)
    assert [r.lsn for r in records] == [1, 2, 3, 4]


def test_wal_crc_corruption_cuts_tail(tmp_path):
    path = str(tmp_path / "wal.log")
    wal, _ = WriteAheadLog.open(path)
    offsets = [0]
    for i in range(3):
        wal.append("insert", np.full((1, 2), i, np.float32), np.array([i]))
        offsets.append(wal.bytes_written)
    wal.close()
    raw = bytearray(open(path, "rb").read())
    raw[offsets[1] + 12] ^= 0xFF  # a payload byte of record 2
    open(path, "wb").write(bytes(raw))
    wal2, records = WriteAheadLog.open(path)
    assert [r.lsn for r in records] == [1]  # record 2 and all after it cut
    assert wal2.truncated_bytes == len(raw) - offsets[1]
    wal2.close()


def test_wal_group_commit_defers_fsync(tmp_path):
    wal, _ = WriteAheadLog.open(str(tmp_path / "wal.log"),
                                fsync_interval_ms=10_000.0)
    for i in range(5):
        wal.append("insert", np.ones((1, 2), np.float32), np.array([i]))
    assert wal.last_lsn == 5 and wal.synced_lsn < 5 and wal.fsyncs == 0
    wal.sync()
    assert wal.synced_lsn == 5 and wal.fsyncs == 1
    wal.sync()
    assert wal.fsyncs == 1  # a no-op when durable
    wal.close()


def test_crashpoint_is_noop_when_unarmed():
    crashpoint("wal.append.post")
    with pytest.raises(AssertionError):
        with inject_crashes("wal.append.post"):
            crashpoint("not.a.point")
    with pytest.raises(ValueError, match="unknown crash points"):
        inject_crashes("also.not.a.point").__enter__()


# ----------------------------------------------------- crash-point matrix

@pytest.mark.parametrize("point", CRASH_POINTS)
def test_crashpoint_recovery_matrix(base_snapshot, tmp_path, point):
    """Kill the process state at every registered boundary; recovery
    serves, bit for bit, what an uncrashed twin serves after the prefix of
    the writes the protocol says survived."""
    work = str(tmp_path / "db")
    shutil.copytree(base_snapshot, work)
    script = _script(11)
    db = _mk_db().restore_index(work, durable=True)
    applied = 0
    with inject_crashes(point) as inj:
        try:
            for i, (kind, vec, ids) in enumerate(script):
                if i == _SNAP_AT:
                    db.save_index(work, step=1, durable=True)
                db.apply_write(kind, vectors=vec, ids=ids)
                applied += 1
        except SimulatedCrash:
            pass
    assert inj.fired == [point], f"{point} never fired"
    db.wal._f.close()  # the dead process holds no handles
    del db
    # wal.append.pre dies before the record reaches the file (the write
    # is lost); append.post and sync.post after it (the write survives);
    # the snapshot points fire inside the save, losing nothing logged
    surviving = applied + (1 if point in ("wal.append.post",
                                          "wal.sync.post") else 0)
    recovered = _mk_db().restore_index(work, durable=True)
    oracle = _mk_db().restore_index(base_snapshot)
    for kind, vec, ids in script[:surviving]:
        oracle.apply_write(kind, vectors=vec, ids=ids)
    assert recovered.n == oracle.n
    assert recovered.generation == oracle.generation
    q = np.random.default_rng(5).normal(size=(6, D)).astype(np.float32)
    _same_answers(oracle, recovered, q)
    recovered.apply_write("insert", vectors=q[:1], ids=None)
    assert recovered.wal.synced_lsn == recovered.wal.last_lsn


def test_crash_between_snapshot_rename_and_truncate_replays_by_lsn(
        base_snapshot, tmp_path):
    work = str(tmp_path / "db")
    shutil.copytree(base_snapshot, work)
    db = _mk_db().restore_index(work, durable=True)
    db.insert(np.random.default_rng(3).normal(size=(2, D)).astype(np.float32))
    with inject_crashes("wal.truncate.pre"):
        with pytest.raises(SimulatedCrash):
            db.save_index(work, step=1, durable=True)
    db.wal._f.close()
    del db
    assert ckpt.load_meta(work, 1)["wal_lsn"] == 1  # the log still holds 1
    recovered = _mk_db().restore_index(work, durable=True)
    assert recovered.wal.recovered_records == 0  # skipped, not re-applied
    assert recovered.n == 50


def test_durable_write_after_snapshot_restart_survives_crash(
        base_snapshot, tmp_path):
    """After a truncating snapshot, a restart reopens the log with its lsn
    counter floored at the stamp, so that new fsync'd writes replay."""
    work = str(tmp_path / "db")
    shutil.copytree(base_snapshot, work)
    rng = np.random.default_rng(21)
    db = _mk_db().restore_index(work, durable=True)
    db.insert(rng.normal(size=(2, D)).astype(np.float32))  # lsn 1
    db.save_index(work, step=1, durable=True)
    db.wal.close()
    db = _mk_db().restore_index(work, durable=True)
    assert db.wal.recovered_records == 0 and db.wal.last_lsn == 1
    rows = rng.normal(size=(4, D)).astype(np.float32)
    db.insert(rows)
    assert db.wal.last_lsn == db.wal.synced_lsn == 2
    n_before = db.n
    db.wal._f.close()  # crash
    recovered = _mk_db().restore_index(work, durable=True)
    assert recovered.wal.recovered_records == 1 and recovered.n == n_before
    st = recovered.restore_stats
    assert st["step"] == 1 and st["replayed"] == 1 and st["bytes"] > 0
    assert st["load_s"] >= st["read_s"] + st["upload_s"] > 0
    oracle = _mk_db().restore_index(work, step=1)
    oracle.insert(rows)
    q = rng.normal(size=(4, D)).astype(np.float32)
    _same_answers(oracle, recovered, q)


def test_save_index_rejects_snapshot_away_from_attached_wal(
        base_snapshot, tmp_path):
    work = str(tmp_path / "db")
    shutil.copytree(base_snapshot, work)
    db = _mk_db().restore_index(work, durable=True)
    with pytest.raises(ValueError, match="WAL is attached"):
        db.save_index(str(tmp_path / "elsewhere"), step=1, durable=True)
    db.save_index(work, step=1, durable=True)


def test_torn_wal_tail_recovers_prefix(base_snapshot, tmp_path):
    work = str(tmp_path / "db")
    shutil.copytree(base_snapshot, work)
    db = _mk_db().restore_index(work, durable=True)
    rng = np.random.default_rng(9)
    rows = rng.normal(size=(3, D)).astype(np.float32)
    db.insert(rows[:1])
    db.insert(rows[1:2])
    db.wal._f.close()
    del db
    wal_path = os.path.join(work, "wal.log")
    raw = open(wal_path, "rb").read()
    open(wal_path, "wb").write(raw[:-7])  # tear the last record
    recovered = _mk_db().restore_index(work, durable=True)
    assert recovered.wal.recovered_records == 1
    assert recovered.wal.truncated_bytes > 0
    oracle = _mk_db().restore_index(base_snapshot)
    oracle.insert(rows[:1])
    _same_answers(oracle, recovered, rng.normal(size=(4, D)).astype(np.float32))


# ------------------------------------------------- snapshot cadence

def test_auto_snapshot_by_bytes_truncates_and_recovers(base_snapshot,
                                                       tmp_path):
    work = str(tmp_path / "db")
    shutil.copytree(base_snapshot, work)
    db = _mk_db().restore_index(work)
    db.attach_wal(work, snapshot_every_bytes=1)  # every write trips it
    rng = np.random.default_rng(13)
    rows = rng.normal(size=(3, D)).astype(np.float32)
    for r in rows:
        db.insert(r[None])
    assert db.wal_stats["auto_snapshots"] == 3
    assert ckpt.valid_steps(work) == [0, 1, 2, 3]
    assert ckpt.load_meta(work, 3)["wal_lsn"] == 3
    db.wal.close()
    recovered = _mk_db().restore_index(work, durable=True)
    assert recovered.wal.recovered_records == 0
    oracle = _mk_db().restore_index(base_snapshot)
    oracle.insert(rows)
    _same_answers(oracle, recovered, rng.normal(size=(5, D)).astype(np.float32))


def test_snapshot_cadence_thresholds_and_explicit_save_reset(base_snapshot,
                                                             tmp_path):
    work = str(tmp_path / "db")
    shutil.copytree(base_snapshot, work)
    db = _mk_db().restore_index(work)
    rows = np.random.default_rng(17).normal(size=(8, D)).astype(np.float32)
    one = len(encode_record(1, "insert", vectors=rows[:1],
                            ids=torch.tensor([0])))
    db.attach_wal(work, snapshot_every_bytes=int(one * 2.5))
    db.insert(rows[0:1])
    db.insert(rows[1:2])
    assert db.wal_stats["auto_snapshots"] == 0
    db.insert(rows[2:3])
    assert db.wal_stats["auto_snapshots"] == 1
    assert max(ckpt.valid_steps(work)) == 1
    db.insert(rows[3:4])
    assert db.wal_stats["auto_snapshots"] == 1
    db.insert(rows[4:5])
    db.save_index(work, step=7, durable=True)  # an explicit save resets too
    db.insert(rows[5:6])
    db.insert(rows[6:7])
    assert db.wal_stats["auto_snapshots"] == 1
    db.insert(rows[7:8])
    assert db.wal_stats["auto_snapshots"] == 2
    assert max(ckpt.valid_steps(work)) == 8


def test_auto_snapshot_by_age(base_snapshot, tmp_path):
    work = str(tmp_path / "db")
    shutil.copytree(base_snapshot, work)
    db = _mk_db().restore_index(work)
    db.attach_wal(work, snapshot_every_s=0.0)
    db.insert(np.random.default_rng(19).normal(size=(2, D)).astype(np.float32))
    db.delete(np.array([3]))
    assert db.wal_stats["auto_snapshots"] == 2


def test_snapshot_cadence_requires_persistence(rng, tmp_path):
    db = VectorDB("flat", metric="l2", device="cpu").load(
        rng.normal(size=(10, D)).astype(np.float32))

    class NoState:  # an engine that cannot snapshot
        def __init__(self, inner):
            self.size = inner.size

    db.index = NoState(db.index)
    with pytest.raises(NotImplementedError, match="cadence"):
        db.attach_wal(str(tmp_path), snapshot_every_bytes=1024)
    with pytest.raises(NotImplementedError, match="persistence"):
        db.save_index(str(tmp_path))


# ------------------------------------------------- snapshot-dir fallback

def test_restore_skips_partial_and_corrupt_steps(tmp_path, rng):
    corpus = rng.normal(size=(40, D)).astype(np.float32)
    kw = dict(m=4, ksub=16, refine=4096, device="cpu")
    db = VectorDB("pq", **kw).load(corpus)
    db.save_index(str(tmp_path), step=0)
    db.insert(rng.normal(size=(5, D)).astype(np.float32))
    db.save_index(str(tmp_path), step=1)
    db.insert(rng.normal(size=(5, D)).astype(np.float32))
    db.save_index(str(tmp_path), step=2)
    step2 = tmp_path / "step_00000002"  # a leaf file vanishes
    next(f for f in step2.iterdir() if f.suffix == ".npy").unlink()
    step1 = tmp_path / "step_00000001"  # a leaf file torn mid-write
    leaf = next(f for f in step1.iterdir()
                if f.suffix == ".npy" and f.name.startswith("codes"))
    with open(leaf, "r+b") as fh:
        fh.truncate(fh.seek(0, os.SEEK_END) // 2)
    (tmp_path / "step_00000003.tmp").mkdir()  # debris of a crashed save
    assert ckpt.valid_steps(str(tmp_path)) == [0, 1]
    with pytest.warns(UserWarning, match="skipping snapshot step 1"):
        db2 = VectorDB("pq", **kw).restore_index(str(tmp_path))
    assert db2.n == 40
    shutil.rmtree(tmp_path / "step_00000000")
    with pytest.raises(RuntimeError, match="no"):
        VectorDB("pq", **kw).restore_index(str(tmp_path))


def test_restore_rebuilds_a_fresh_engine_after_a_partial_load(tmp_path, rng):
    """A step whose engine leaves are incomplete (a KeyError in
    ``load_state``) is skipped, and the next step loads into a fresh
    engine built from the kwargs the front kept."""
    corpus = rng.normal(size=(40, D)).astype(np.float32)
    kw = dict(m=4, ksub=16, refine=4096, device="cpu")
    db = VectorDB("pq", **kw).load(corpus)
    db.save_index(str(tmp_path), step=0)
    db.insert(rng.normal(size=(5, D)).astype(np.float32))
    db.save_index(str(tmp_path), step=1)
    step1 = tmp_path / "step_00000001"
    manifest = (step1 / "manifest.json").read_text()
    (step1 / "manifest.json").write_text(manifest.replace('"codebooks"',
                                                          '"codebooks_x"'))
    with pytest.warns(UserWarning, match="skipping snapshot step 1"):
        db2 = VectorDB("pq", **kw).restore_index(str(tmp_path))
    assert db2.n == 40 and db2.index.m == 4 and db2.index.refine == 4096


# -------------------------------------------------- async group commit

def test_async_engine_acks_only_after_fsync(base_snapshot, tmp_path):
    work = str(tmp_path / "db")
    shutil.copytree(base_snapshot, work)
    rng = np.random.default_rng(2)
    db = _mk_db().restore_index(work, durable=True)
    with AsyncQueryEngine(db, max_batch=8, max_wait_ms=1.0,
                          fsync_interval_ms=20.0) as eng:
        futs = [eng.submit_write(
            "insert", rng.normal(size=(1, D)).astype(np.float32))
            for _ in range(16)]
        for f in futs:
            kind, ids = f.result(timeout=30)
            # writes apply in order, a row each, from next_id 48: the write
            # that got id i is lsn i - 47, fsync'd by the time it resolves
            assert db.wal.synced_lsn >= int(ids[0]) - 47
        eng.drain(timeout=30)
        st = eng.latency_stats()
    assert st["wal_records"] == 16
    assert st["wal_fsyncs"] < st["wal_records"]
    assert st["wal_synced_lsn"] == st["wal_last_lsn"] == 16
    assert st["durable_pending"] == 0
    db.wal.close()
    db2 = _mk_db().restore_index(work, durable=True)
    assert db2.wal.recovered_records == 16
    with AsyncQueryEngine(db2, fsync_interval_ms=0.0) as eng:
        for _ in range(4):
            eng.submit_write(
                "insert",
                rng.normal(size=(1, D)).astype(np.float32)).result(timeout=30)
        st = eng.latency_stats()
    assert st["wal_fsyncs"] == st["wal_records"] == 4


# ------------------------------------------------------------- the fuzz

_WAL_CRASH_POINTS = ("wal.append.pre", "wal.append.post", "wal.sync.post")


def _run_crash_fuzz(seed: int, n_steps: int = 14):
    """Writes, snapshots, crashes and recoveries in a seeded order on a
    durable ivf_pq against a dict oracle: after every recovery (and at the
    end) the top-k is brute force over the rows the protocol says
    survived."""
    rng = np.random.default_rng(seed)
    work = tempfile.mkdtemp(prefix="walfuzz")
    try:
        n0 = 40
        corpus = rng.normal(size=(n0, D)).astype(np.float32)
        db = _mk_db().load(corpus)
        db.save_index(work, step=0, durable=True)
        vecs = {i: corpus[i] for i in range(n0)}
        q = rng.normal(size=(3, D)).astype(np.float32)
        snap_step = 1
        for step in range(n_steps):
            op = rng.choice(["insert", "delete", "upsert", "compact",
                             "snapshot", "crash"],
                            p=[0.3, 0.15, 0.15, 0.05, 0.1, 0.25])
            if op == "snapshot":
                db.save_index(work, step=snap_step, durable=True)
                snap_step += 1
                continue
            if op == "crash":
                point = str(rng.choice(_WAL_CRASH_POINTS))
                kind = str(rng.choice(["insert", "delete"]))
                rows = rng.normal(size=(1, D)).astype(np.float32)
                del_ids = np.array([sorted(vecs)[0]]) if vecs else np.array([0])
                next_id = db.index.next_id
                with inject_crashes(point) as inj:
                    try:
                        if kind == "insert":
                            db.apply_write("insert", vectors=rows)
                        else:
                            db.apply_write("delete", ids=del_ids)
                    except SimulatedCrash:
                        pass
                db.wal._f.close()
                db = _mk_db().restore_index(work, durable=True)
                if inj.fired and point != "wal.append.pre":
                    if kind == "insert":
                        vecs[int(next_id)] = rows[0]
                    else:
                        vecs.pop(int(del_ids[0]), None)
                _check_exact(db, vecs, q, 6, "l2",
                             f"step {step} recover {point}/{kind}")
                continue
            if op == "insert":
                rows = rng.normal(
                    size=(int(rng.integers(1, 4)), D)).astype(np.float32)
                ids = db.insert(rows)
                vecs.update({int(i): r for i, r in zip(ids, rows)})
            elif op == "delete" and vecs:
                take = rng.choice(sorted(vecs),
                                  size=min(len(vecs), int(rng.integers(1, 4))),
                                  replace=False)
                db.delete(take)
                for i in take:
                    vecs.pop(int(i))
            elif op == "upsert":
                ids = np.unique(rng.integers(0, db.index.next_id, size=2))
                rows = rng.normal(size=(ids.size, D)).astype(np.float32)
                db.upsert(rows, ids)
                vecs.update({int(i): r for i, r in zip(ids, rows)})
            else:
                db.compact()
        db.wal._f.close()
        db = _mk_db().restore_index(work, durable=True)
        _check_exact(db, vecs, q, 6, "l2", "final recover")
        assert db.n == len(vecs)
        db.wal.close()
    finally:
        shutil.rmtree(work, ignore_errors=True)


@pytest.mark.parametrize("seed", [0, 1])
def test_crash_recovery_fuzz_seeded(seed):
    _run_crash_fuzz(seed)


def test_crash_recovery_fuzz_hypothesis():
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st

    @given(seed=st.integers(0, 2 ** 16))
    @settings(max_examples=5, deadline=None)
    def run(seed):
        _run_crash_fuzz(seed, n_steps=10)

    run()


# ------------------------------------------------------ checkpoint store

@pytest.fixture
def tree():
    return {"params": {"w": torch.arange(24, dtype=torch.float32).reshape(4, 6),
                       "b": torch.ones(3, dtype=torch.bfloat16)},
            "opt": {"step": torch.tensor(7, dtype=torch.int32)}}


def _flat(t, prefix=""):
    for k, v in sorted(t.items()):
        if isinstance(v, dict):
            yield from _flat(v, prefix + k + "/")
        else:
            yield prefix + k, v


def test_checkpoint_roundtrip(tmp_path, tree):
    ckpt.save(tree, str(tmp_path), 3)
    out = ckpt.restore(tree, str(tmp_path), 3)
    for (ka, a), (kb, b) in zip(_flat(tree), _flat(out)):
        assert ka == kb and a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_files_match_the_reference(tmp_path, tree):
    """The same tree saved by each package: the same files, manifest leaves
    and bytes (bf16 as uint16 bits)."""
    ckpt.save(tree, str(tmp_path / "port"), 3, meta={"a": 1})
    jtree = {"params": {"w": jnp.arange(24, dtype=jnp.float32).reshape(4, 6),
                        "b": jnp.ones((3,), jnp.bfloat16)},
             "opt": {"step": jnp.asarray(7, jnp.int32)}}
    rckpt.save(jtree, str(tmp_path / "ref"), 3, meta={"a": 1})
    import json
    mp = json.load(open(tmp_path / "port" / "step_00000003" / "manifest.json"))
    mr = json.load(open(tmp_path / "ref" / "step_00000003" / "manifest.json"))
    assert mp == mr
    for name in os.listdir(tmp_path / "ref" / "step_00000003"):
        assert (open(tmp_path / "port" / "step_00000003" / name, "rb").read()
                == open(tmp_path / "ref" / "step_00000003" / name, "rb").read())


def test_bf16_roundtrip_exact(tmp_path):
    x = {"w": (torch.arange(100, dtype=torch.float32) * 0.37).bfloat16()}
    ckpt.save(x, str(tmp_path), 1)
    out = ckpt.restore(x, str(tmp_path), 1)
    assert out["w"].dtype == torch.bfloat16 and torch.equal(out["w"], x["w"])
    ref = rckpt.load_arrays(str(tmp_path), 1)["w"]  # ml_dtypes bf16
    np.testing.assert_array_equal(np.asarray(ref, np.float32),
                                  x["w"].float().numpy())


def test_chunked_large_leaf(tmp_path):
    x = {"big": torch.randn(1024, 300)}
    ckpt.save(x, str(tmp_path), 1, chunk_mb=1)  # several chunks
    files = sorted(os.listdir(tmp_path / "step_00000001"))
    assert len([f for f in files if f.startswith("big.")]) > 1
    assert torch.equal(ckpt.restore(x, str(tmp_path), 1)["big"], x["big"])
    assert torch.equal(ckpt.load_arrays(str(tmp_path), 1)["big"], x["big"])
    np.testing.assert_array_equal(rckpt.load_arrays(str(tmp_path), 1)["big"],
                                  x["big"].numpy())


def test_load_arrays_forms(tmp_path):
    """Strings come back as str, 0-d leaves as Python scalars, arrays as
    tensors on the device asked for; a reference uint32 leaf as int32
    bits."""
    rckpt.save({"engine": np.asarray("lsh"), "d": np.asarray(8, np.int32),
                "codes": np.array([1, 2 ** 32 - 1], np.uint32)},
               str(tmp_path), 0)
    got = ckpt.load_arrays(str(tmp_path), 0, device="cpu")
    assert got["engine"] == "lsh" and got["d"] == 8
    assert got["codes"].dtype == torch.int32
    assert got["codes"].tolist() == [1, -1]


def test_latest_and_retention(tmp_path, tree):
    store = CheckpointStore(str(tmp_path), keep=2)
    for s in (1, 2, 3):
        store.save(tree, s)
    assert store.latest_step() == 3
    assert sorted(os.listdir(tmp_path)) == ["step_00000002", "step_00000003"]


def test_async_save(tmp_path, tree):
    store = CheckpointStore(str(tmp_path))
    store.save_async(tree, 5)
    tree["params"]["w"].zero_()  # the host copy was taken at the call
    store.wait()
    out, step = store.restore(tree)
    assert step == 5
    assert out["params"]["w"].reshape(-1).tolist() == list(range(24))


def test_atomic_no_tmp_left(tmp_path, tree):
    ckpt.save(tree, str(tmp_path), 1)
    assert not any(d.endswith(".tmp") for d in os.listdir(tmp_path))


def test_restore_missing_raises(tmp_path, tree):
    store = CheckpointStore(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        store.restore(tree)
    ckpt.save({"other": torch.zeros(2)}, str(tmp_path), 1)
    with pytest.raises(KeyError, match="other"):
        store.restore(tree)


def test_async_save_retries_transient_io(tmp_path, tree, monkeypatch):
    from repro_torch.checkpoint import store as store_mod
    real_save = store_mod.save
    fails = {"n": 2}

    def flaky(*a, **kw):
        if fails["n"] > 0:
            fails["n"] -= 1
            raise OSError("transient write failure")
        return real_save(*a, **kw)

    monkeypatch.setattr(store_mod, "save", flaky)
    store = CheckpointStore(str(tmp_path), retries=3, backoff_s=0.001)
    handle = store.save_async(tree, 7)
    assert handle.result(timeout=30).endswith("step_00000007")
    assert handle.attempts == 3 and handle.exception() is None
    store.wait()
    assert store.latest_step() == 7


def test_async_save_terminal_failure_surfaces(tmp_path, tree, monkeypatch):
    from repro_torch.checkpoint import store as store_mod

    def doomed(*a, **kw):
        raise OSError("disk on fire")

    monkeypatch.setattr(store_mod, "save", doomed)
    store = CheckpointStore(str(tmp_path), retries=2, backoff_s=0.001)
    handle = store.save_async(tree, 9)
    assert isinstance(handle.exception(timeout=30), OSError)
    assert handle.attempts == 3
    with pytest.raises(OSError, match="disk on fire"):
        handle.result()
    with pytest.raises(OSError, match="disk on fire"):
        store.wait()
    store.wait()
    assert store.latest_step() is None


def test_valid_steps_filters_partial_dirs(tmp_path, tree):
    for s in (1, 2, 3):
        ckpt.save(tree, str(tmp_path), s)
    step3 = tmp_path / "step_00000003"
    next(f for f in step3.iterdir() if f.suffix == ".npy").unlink()
    (tmp_path / "step_00000004.tmp").mkdir()
    (tmp_path / "step_00000004.tmp" / "manifest.json").write_text("{}")
    assert ckpt.valid_steps(str(tmp_path)) == [1, 2]
    assert ckpt.latest_valid_step(str(tmp_path)) == 2
    assert not ckpt.is_valid_step(str(tmp_path), 3)
    assert not ckpt.is_valid_step(str(tmp_path), 4)
    (step3 / "manifest.json").write_text("not json")
    assert not ckpt.is_valid_step(str(tmp_path), 3)


def test_manifest_records_pspecs_as_the_reference_does(tmp_path, tree):
    """``save(pspecs=)`` writes each leaf's partition spec in the
    reference's manifest form (tests/test_checkpoint.py), equal field for
    field to the reference's own save of the same tree and specs; a leaf
    without a spec reads null."""
    import json
    from jax.sharding import PartitionSpec as JP
    from repro_torch.core.distributed import P
    specs = {"params": {"w": P("data", None), "b": P()},
             "opt": {"step": P()}}
    ckpt.save(tree, str(tmp_path / "port"), 2, pspecs=specs)
    ckpt.save(tree, str(tmp_path / "nospec"), 2)
    ref_tree = {"params": {"w": np.arange(24, dtype=np.float32).reshape(4, 6),
                           "b": np.ones(3, np.float32)},
                "opt": {"step": np.asarray(7, np.int32)}}
    rckpt.save(ref_tree, str(tmp_path / "ref"), 2, pspecs={
        "params": {"w": JP(("data", "model"), None), "b": JP()},
        "opt": {"step": JP()}})
    ckpt.save(tree, str(tmp_path / "port2"), 2, pspecs={
        "params": {"w": P(("data", "model"), None), "b": P()},
        "opt": {"step": P()}})

    def leaves(name):
        path = tmp_path / name / "step_00000002" / "manifest.json"
        return json.loads(path.read_text())["leaves"]

    assert leaves("port")["params/w"]["pspec"] == ["data", None]
    assert leaves("port")["params/b"]["pspec"] == []
    assert leaves("nospec")["params/w"]["pspec"] is None
    for key, leaf in leaves("ref").items():
        assert leaves("port2")[key]["pspec"] == leaf["pspec"], key
    assert leaves("ref")["params/w"]["pspec"] == [["data", "model"], None]


def test_restore_resharded_places_leaves_on_a_new_mesh(tmp_path, tree):
    """A tree saved from 4 row shards, restored onto a (2, 4) mesh of the
    CPU: the sharded leaf as 8 slabs of its rows over both axes, the
    replicated ones whole on the merge device, every value and dtype kept;
    a leaf whose rows do not split, or a spec past the first dimension,
    is refused."""
    from repro_torch.core import distributed as dist
    mesh4 = dist.make_mesh((4,), ("data",), devices=["cpu"] * 4)
    rows = torch.arange(16 * 3, dtype=torch.float32).reshape(16, 3)
    placed = dist.corpus_sharding(mesh4).place(rows)
    assert [s.shape for s in placed.shards] == [(4, 3)] * 4
    saved = dict(tree, rows=placed.gather())
    ckpt.save(saved, str(tmp_path), 1, pspecs={"rows": placed.sharding.spec})
    mesh8 = dist.make_mesh((2, 4), ("data", "model"), devices=["cpu"] * 8)

    def sharding(key, leaf):
        return dist.NamedSharding(mesh8, dist.P(("data", "model"), None)
                                  if key == "rows" else dist.P())

    got = ckpt.restore_resharded(saved, str(tmp_path), 1, mesh8, sharding)
    assert isinstance(got["rows"], dist.ShardedRows)
    assert len(got["rows"].shards) == 8 and got["rows"].local_n == 2
    assert torch.equal(got["rows"].gather(), rows)
    assert torch.equal(got["params"]["w"], tree["params"]["w"])
    assert got["params"]["b"].dtype == torch.bfloat16
    assert int(got["opt"]["step"]) == 7
    with pytest.raises(ValueError, match="do not split"):
        ckpt.restore_resharded({"params": {"w": tree["params"]["w"]}},
                               str(tmp_path), 1, mesh8,
                               lambda key, leaf: dist.NamedSharding(
                                   mesh8, dist.P(("data", "model"), None)))
    with pytest.raises(ValueError, match="first dimension"):
        dist.NamedSharding(mesh8, dist.P(None, "data"))


# ------------------------------------------------ across the packages
N0 = 300
META = {"tag": (np.arange(N0) % 10).tolist(),
        "src": ["s%d" % (i % 3) for i in range(N0)]}
CROSS = [("flat", "l2", {}), ("flat", "l2", {"dtype": "bfloat16"}),
         ("flat", "cosine", {"dtype": "bfloat16"}),
         ("pq", "cosine", {"m": 4, "ksub": 16}),
         ("pq", "l2", {"m": 4, "ksub": 16, "refine": 0}),
         ("ivf_pq", "cosine", {"n_clusters": 6, "nprobe": 3, "m": 4,
                               "ksub": 16, "block_size": 8}),
         ("ivf_pq", "l2", {"n_clusters": 6, "nprobe": 6, "m": 4, "ksub": 16,
                           "refine": 0, "block_size": 8})]


def _writes(rng, d):
    """A write mix with metadata, as (kind, vectors, ids, meta)."""
    x = rng.normal(size=(40, d)).astype(np.float32) / 2
    return [("insert", x[:12], None, {"tag": [7] * 12, "src": ["w"] * 12}),
            ("delete", None, np.array([3, 4, 5, 301]), None),
            ("upsert", x[12:16], np.array([10, 11, 302, 303]),
             {"tag": [8, 8, 8, 8], "src": ["u"] * 4}),
            ("insert", x[16:20], None, None),
            ("compact", None, None, None)]


def _ref_db(engine, metric, kw, corpus):
    jkw = dict(kw)
    if jkw.get("dtype") == "bfloat16":
        jkw["dtype"] = jnp.bfloat16
    if engine != "flat":
        jkw["use_kernel"] = False
    return JaxVectorDB(engine, metric=metric, **jkw).load(corpus, meta=META)


def _port_kw(kw):
    out = dict(kw, device="cpu")
    if out.get("dtype") == "bfloat16":
        out["dtype"] = torch.bfloat16
    return out


def _tol(metric, kw):
    return BF16_COSINE_TOL if (kw.get("dtype") and metric == "cosine") \
        else TOL


def _compare(port, ref, q, metric, kw):
    tol = _tol(metric, kw)
    assert port.n == ref.n
    for k in (1, 10):
        _assert_same(port.query(q, k=k), ref.query(q, k=k), tol)
    _assert_same(port.query(q, k=10, where=Eq("tag", 7)),
                 ref.query(q, k=10, where=JEq("tag", 7)), tol)
    _assert_same(port.query(q, k=10, where=Range("tag", hi=3)),
                 ref.query(q, k=10, where=JRange("tag", hi=3)), tol)


def _flat_ref_snapshot(jdb, directory):
    """The reference's flat engine keeps no state_dict: write its leaves
    (the float32 mirror, or its bf16 device corpus) through the reference's
    own checkpoint store."""
    idx = jdb.index
    n = idx.next_id
    bf16 = str(idx.dtype) == "bfloat16"
    state = {"engine": np.asarray("flat"), "metric": np.asarray(idx.metric),
             "dtype": np.asarray(str(idx.dtype)),
             "corpus": (idx.corpus[:n] if bf16 else idx._corpus.data[:n]),
             "live": idx._valid.data[:n],
             "generation": np.asarray(idx.generation, np.int64)}
    if idx._sq is not None:
        state["corpus_sq"] = idx._sq.data[:n]
    state.update(jdb.metastore.state_leaves())
    rckpt.save(state, directory, 0, meta={"engine": "flat", "wal_lsn": 0})


@pytest.mark.parametrize("engine,metric,kw", CROSS)
def test_reference_snapshot_and_wal_restore_in_the_port(tmp_path, engine,
                                                        metric, kw):
    rng = np.random.default_rng(31)
    corpus = rng.normal(size=(N0, 12)).astype(np.float32) / 2
    q = corpus[:6] + 0.05
    ref = _ref_db(engine, metric, kw, corpus)
    work = str(tmp_path)
    if engine == "flat":
        ref.index._sync()
        _flat_ref_snapshot(ref, work)
        ref.attach_wal(work)
    else:
        ref.save_index(work, 0, durable=True)
    for kind, vec, ids, meta in _writes(rng, 12):
        ref.apply_write(kind, vectors=vec, ids=ids, meta=meta)
    ref.wal.close()
    port = VectorDB(engine, metric=metric, **_port_kw(kw)).restore_index(
        work, durable=True)
    assert port.wal.recovered_records == 5
    assert port.metastore.cols.keys() == ref.metastore.cols.keys()
    _compare(port, ref, q, metric, kw)
    port.wal.close()


@pytest.mark.parametrize("engine,metric,kw", CROSS)
def test_port_snapshot_and_wal_restore_in_the_reference(tmp_path, engine,
                                                        metric, kw):
    rng = np.random.default_rng(37)
    corpus = rng.normal(size=(N0, 12)).astype(np.float32) / 2
    q = corpus[:6] + 0.05
    if engine == "flat":
        port = VectorDB(engine, metric=metric, **_port_kw(kw)).load(
            corpus, meta=META)
    else:  # the reference trains; the port takes its state
        from repro_torch.core.convert import from_reference_state
        jdb = _ref_db(engine, metric, kw, corpus)
        state = {k: np.asarray(v) for k, v in jdb.index.state_dict().items()}
        state.update(jdb.metastore.state_leaves())
        port = VectorDB(engine, metric=metric, **_port_kw(kw)).load_state(
            from_reference_state(state))
    work = str(tmp_path)
    port.save_index(work, 0, durable=True)
    for kind, vec, ids, meta in _writes(rng, 12):
        port.apply_write(kind, vectors=vec, ids=ids, meta=meta)
    port.wal.close()
    if engine == "flat":
        # the reference's flat cannot restore_index: load the port's leaves
        # into it, tombstone the dead rows, and replay the port's log
        arrays = rckpt.load_arrays(work, 0)
        ref = _ref_db(engine, metric, kw, np.asarray(arrays["corpus"],
                                                    np.float32))
        from repro.search import MetadataStore as JStore
        ref.metastore = JStore.from_leaves(arrays)
        if "corpus_sq" in arrays:  # |c|^2 of the float32 rows, not of bf16
            ref.index._sq.data[:N0] = np.asarray(arrays["corpus_sq"])
            ref.index._dirty = True
        dead = np.flatnonzero(~np.asarray(arrays["live"]))
        if dead.size:
            ref.index.delete(dead)
        _wal, records = rwal.WriteAheadLog.open(os.path.join(work, "wal.log"))
        _wal.close()
        for rec in records:
            ref.apply_write(rec.kind, vectors=rec.vectors, ids=rec.ids,
                            meta=rec.meta)
    else:
        jkw = dict(kw, use_kernel=False)
        ref = JaxVectorDB(engine, metric=metric, **jkw).restore_index(
            work, durable=True)
        assert ref.wal.recovered_records == 5
        ref.wal.close()
    _compare(port, ref, q, metric, kw)
