"""Write-ahead log: crash durability for the write path (port of
``repro.core.wal``, the same framing, so that either package reads and
replays the other's logs).

One framed record per insert, delete, upsert or compact is appended (and
fsync'd, per the group-commit policy) before the write is acknowledged;
recovery replays the log's tail through the write API on top of the latest
valid snapshot (``VectorDB.restore_index(durable=True)``).

Record format (little-endian)::

    frame   := u32 payload_len | u32 crc32(payload) | payload
    payload := u32 header_len | header (JSON, utf-8) | vec_bytes | id_bytes

The JSON header carries ``lsn`` (1-based, strictly increasing), ``kind``,
the shape and dtype of the two optional array segments and, where the write
carried metadata, ``meta`` (the columnar form of ``search.meta``). A record
is self-describing. Arrays are logged in the caller's dtype: the port's
ids are int64, the reference's int32, and each decodes the other's; bf16
is logged as its two-byte values under the dtype name ``"bfloat16"``, as
the reference logs ml_dtypes' bf16, and decodes to ``torch.bfloat16``.
Tensors on the card are copied to the host for the append.

A torn tail (power lost mid-append) fails its length or CRC: recovery
scans frames from the start, stops at the first short or corrupt one,
truncates the file back to the last intact frame and replays only what
verified.

Commit protocol (with ``VectorDB.save_index(durable=True)``): the write
applies to the engine; the record is appended and flushed
(``wal.append.post``); fsync'd at once when ``fsync_interval_ms == 0``,
else once that interval has passed since the last fsync, so that
concurrent writes share one (group commit; the async front holds their
acks until then, ``wal.sync.post``); at snapshot commit the manifest
stamps ``wal_lsn`` and the log is truncated to the records after it
(``wal.truncate.pre``: a crash between rename and truncation only means
replay skips covered records by lsn).
"""
from __future__ import annotations

import json
import os
import struct
import time
import zlib
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.ft.faults import crashpoint

_FRAME = struct.Struct("<II")  # payload length, crc32(payload)
_HLEN = struct.Struct("<I")
# a corrupt length field must not make recovery allocate gigabytes
# (records are write batches, far below this)
MAX_RECORD_BYTES = 1 << 30

WAL_KINDS = ("insert", "delete", "upsert", "compact")


@dataclass
class WalRecord:
    lsn: int
    kind: str
    vectors: Optional[torch.Tensor] = None  # CPU tensors as decoded
    ids: Optional[torch.Tensor] = None
    # columnar metadata {column: [values]} aligned to ids (the
    # MetadataStore.normalize form), or None
    meta: Optional[dict] = None


def _arr_meta(arr) -> Tuple[Optional[dict], bytes]:
    """(segment header, bytes) of one array segment, in its own dtype."""
    if arr is None:
        return None, b""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu().contiguous()
        name = str(t.dtype).replace("torch.", "")
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return {"shape": list(t.shape), "dtype": name}, t.numpy().tobytes()
    a = np.ascontiguousarray(arr)
    return {"shape": list(a.shape), "dtype": str(a.dtype)}, a.tobytes()


def _arr_read(meta, buf: bytes, off: int):
    if meta is None:
        return None, off
    name = meta["dtype"]
    bf16 = name == "bfloat16"
    dt = np.dtype(np.int16 if bf16 else name)
    n = int(np.prod(meta["shape"], dtype=np.int64)) * dt.itemsize
    arr = np.frombuffer(buf[off:off + n], dtype=dt).reshape(meta["shape"])
    t = torch.from_numpy(arr.copy())
    return (t.view(torch.bfloat16) if bf16 else t), off + n


def encode_record(lsn: int, kind: str, vectors=None, ids=None,
                  meta=None) -> bytes:
    """One CRC32-framed record. ``vectors``/``ids`` are optional arrays or
    tensors (insert and upsert log both, delete ids, compact neither);
    ``meta`` rides in the JSON header, absent from it when None, so a
    record without metadata encodes as the reference's older records do."""
    if kind not in WAL_KINDS:
        raise ValueError(f"unknown record kind {kind!r}; have {WAL_KINDS}")
    vmeta, vbytes = _arr_meta(vectors)
    imeta, ibytes = _arr_meta(ids)
    head = {"lsn": int(lsn), "kind": kind, "vectors": vmeta, "ids": imeta}
    if meta is not None:
        head["meta"] = meta
    header = json.dumps(head).encode()
    payload = _HLEN.pack(len(header)) + header + vbytes + ibytes
    return _FRAME.pack(len(payload), zlib.crc32(payload)) + payload


def decode_payload(payload: bytes) -> WalRecord:
    (hlen,) = _HLEN.unpack_from(payload)
    header = json.loads(payload[_HLEN.size:_HLEN.size + hlen])
    off = _HLEN.size + hlen
    vectors, off = _arr_read(header["vectors"], payload, off)
    ids, _off = _arr_read(header["ids"], payload, off)
    return WalRecord(int(header["lsn"]), header["kind"], vectors, ids,
                     header.get("meta"))


def _scan(raw: bytes):
    """Walk frames from the start; stop at the first short, oversized or
    CRC-failing frame. Returns (records, valid_bytes, reason): reason is
    None for a clean log, else why the tail was cut."""
    records: List[WalRecord] = []
    off = 0
    while off < len(raw):
        if off + _FRAME.size > len(raw):
            return records, off, "short frame header"
        length, crc = _FRAME.unpack_from(raw, off)
        if length > MAX_RECORD_BYTES:
            return records, off, f"implausible frame length {length}"
        payload = raw[off + _FRAME.size: off + _FRAME.size + length]
        if len(payload) < length:
            return records, off, "torn frame payload"
        if zlib.crc32(payload) != crc:
            return records, off, "crc mismatch"
        try:
            records.append(decode_payload(payload))
        except Exception as e:  # framed but undecodable: cut here too
            return records, off, f"undecodable payload ({e})"
        off += _FRAME.size + length
    return records, off, None


def _fsync_dir(path: str) -> None:
    """Make a file's creation or rename durable. Best-effort on
    filesystems that refuse a directory fsync."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


class WriteAheadLog:
    """Append-only log over one file. Not thread-safe: the owning front
    serializes writes (the async front's batcher is the only writer).

    ``fsync_interval_ms`` is the group-commit knob: 0 fsyncs every append;
    > 0 defers the fsync until that much time has passed since the last
    one, so that a burst of appends shares one. ``synced_lsn`` says which
    records are durable; a caller acknowledges nothing past it without
    ``sync()`` first.
    """

    KINDS = WAL_KINDS

    def __init__(self, path: str, fsync_interval_ms: float = 0.0):
        self.path = path
        self.fsync_interval_ms = float(fsync_interval_ms)
        self.last_lsn = 0     # highest lsn appended
        self.synced_lsn = 0   # highest lsn known fsync'd
        self.appends = 0
        self.fsyncs = 0
        self.bytes_written = 0
        self.recovered_records = 0
        self.truncated_bytes = 0
        self._f = None
        self._last_sync_t = time.perf_counter()

    @classmethod
    def open(cls, path: str, fsync_interval_ms: float = 0.0,
             after_lsn: int = 0):
        """Open (or create) the log at ``path``, checking every frame; a
        torn or corrupt tail is truncated to the last intact frame.
        Returns ``(wal, records)``: the intact records with lsn >
        after_lsn, ready to replay."""
        wal = cls(path, fsync_interval_ms)
        raw = b""
        if os.path.exists(path):
            with open(path, "rb") as fh:
                raw = fh.read()
        records, valid, reason = _scan(raw)
        if reason is not None and valid < len(raw):
            with open(path, "r+b") as fh:
                fh.truncate(valid)
                fh.flush()
                os.fsync(fh.fileno())
            wal.truncated_bytes = len(raw) - valid
        created = not os.path.exists(path)
        wal._f = open(path, "ab")
        if created:
            _fsync_dir(os.path.dirname(path) or ".")
        replay = [r for r in records if r.lsn > after_lsn]
        wal.recovered_records = len(replay)
        # new appends take lsns above the snapshot's stamp even when the
        # truncated log is empty: otherwise the next recovery's filter
        # (lsn > after_lsn) would drop acknowledged, fsync'd writes
        wal.last_lsn = wal.synced_lsn = max(
            records[-1].lsn if records else 0, after_lsn)
        return wal, replay

    def append(self, kind: str, vectors=None, ids=None, meta=None) -> int:
        """Frame, write and flush one record; fsync per the group-commit
        policy. Returns its lsn."""
        lsn = self.last_lsn + 1
        rec = encode_record(lsn, kind, vectors, ids, meta)
        crashpoint("wal.append.pre")
        self._f.write(rec)
        self._f.flush()  # in the OS now: survives the process, not power
        self.last_lsn = lsn
        self.appends += 1
        self.bytes_written += len(rec)
        crashpoint("wal.append.post")
        if (self.fsync_interval_ms == 0.0
                or (time.perf_counter() - self._last_sync_t) * 1e3
                >= self.fsync_interval_ms):
            self.sync()
        return lsn

    def sync(self) -> None:
        """Make every appended record durable (no-op when it is)."""
        if self.synced_lsn == self.last_lsn:
            return
        os.fsync(self._f.fileno())
        self.synced_lsn = self.last_lsn
        self.fsyncs += 1
        self._last_sync_t = time.perf_counter()
        crashpoint("wal.sync.post")

    def truncate_through(self, lsn: int) -> None:
        """Drop the records with lsn <= ``lsn`` (a committed snapshot covers
        them). The survivors are rewritten to a tmp file that replaces the
        log, so a crash leaves the old log or the new one; both replay
        right (replay skips by lsn)."""
        self.sync()
        self._f.close()
        with open(self.path, "rb") as fh:
            records, _valid, _reason = _scan(fh.read())
        tmp = self.path + ".tmp"
        with open(tmp, "wb") as fh:
            for r in records:
                if r.lsn > lsn:
                    fh.write(encode_record(r.lsn, r.kind, r.vectors, r.ids,
                                           r.meta))
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, self.path)
        _fsync_dir(os.path.dirname(self.path) or ".")
        self._f = open(self.path, "ab")

    def close(self) -> None:
        if self._f is not None:
            self.sync()
            self._f.close()
            self._f = None

    @property
    def stats(self) -> dict:
        """Durability counters for ``latency_stats``: records against
        fsyncs is the group commit's amortization; synced_lsn lags
        last_lsn by the writes whose acks are held."""
        return {"records": self.appends, "fsyncs": self.fsyncs,
                "last_lsn": self.last_lsn, "synced_lsn": self.synced_lsn,
                "bytes": self.bytes_written,
                "replayed": self.recovered_records,
                "truncated_bytes": self.truncated_bytes}
