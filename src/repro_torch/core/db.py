"""VectorDB: Thistle's load/query trait as the deployment API (port of
``repro.core.db``, the single-host path).

    db = VectorDB(engine="flat|pq|ivf_pq|lsh", metric="cosine|l2|dot")
    db.load(vectors, meta=None)        # meta: the columns filters read
    scores, ids = db.query(q, k=10, where=None, hybrid=None)
    db.load_texts(texts, encoder)      # encoder(list[str]) -> (B, d)
    scores, ids, hits = db.query_texts(texts, encoder, k=10)
    ids = db.insert(new_vectors, meta=None)   # writes: flat, pq, ivf_pq
    db.delete(ids); db.upsert(vs, ids); db.compact(); db.reserve(n)
    db.save_index(dir, step, durable=True)    # snapshot + write-ahead log
    db.restore_index(dir, durable=True)       # latest valid step + replay

The front canonicalizes each batch to the ``PLAN_BUCKETS`` ladder and
counts plan hits and misses as the reference does, so that the serving
layer reads the same counters; padded rows repeat the last query and are
sliced off again. Writes go to the engine (``core.mutable``); when one
changes the engine's ``shape_key`` (a buffer was reallocated),
``plan_generation`` bumps and the next query counts a plan miss.

Durability (``core.wal``, ``checkpoint``): with a write-ahead log attached
every write is logged (an insert with the ids the engine assigned) before
it returns; a snapshot stamps the log's ``wal_lsn`` and truncates the log
behind it; recovery is the latest valid snapshot plus the log's tail.
Filtered search (``search.meta``): a predicate becomes one bitmap over the
id space, built on the host, uploaded to the engine's device once a batch
and ANDed into its validity. Hybrid search fuses BM25
(``search.lexical``) with the dense scores. Entry points run on the GPU
unless given ``device="cpu"``.
"""
from __future__ import annotations

import os
import time
import warnings
from typing import Callable, Dict, Optional, Type

import numpy as np
import torch

from repro_torch import checkpoint as ckpt
from repro_torch.core import distances as D
from repro_torch.core.flat import FlatIndex
from repro_torch.core.ivf import ScheduleCache
from repro_torch.core.lsh import LSHIndex
from repro_torch.core.pq import IVFPQIndex, PQIndex
from repro_torch.core.wal import WriteAheadLog
from repro_torch.device import resolve_device
from repro_torch.ft.faults import crashpoint
from repro_torch.search.lexical import BM25Index, hybrid_merge
from repro_torch.search.meta import MetadataStore, Predicate, filter_hash

ENGINES: Dict[str, Type] = {
    "flat": FlatIndex,      # paper: Iterative (exact); the recall oracle
    "pq": PQIndex,          # product-quantized ADC scan (m bytes a row)
    "ivf_pq": IVFPQIndex,   # IVF buckets of PQ residuals + exact re-rank
    "lsh": LSHIndex,        # paper: LSH; Hamming shortlist + exact re-rank
}
# the reference's other engines, still to port
PENDING_ENGINES = ("ivf", "int8", "graph")

# plan bucket ladder: batches pad up to the next bucket
PLAN_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512)


class _WriteFront:
    """The serving layer's single write entry point: one call dispatches
    any of the four write kinds, so that both serving fronts and WAL replay
    share one write body. Not thread-safe, like the writes themselves: the
    fronts serialize writes and queries on one thread."""

    WRITE_KINDS = ("insert", "delete", "upsert", "compact")

    def apply_write(self, kind: str, vectors=None, ids=None, meta=None):
        """Apply one write batch by kind. Returns the write's own result:
        the ids (insert, upsert), the live rows deleted (delete) or the
        stats dict (compact). ``meta`` (the columnar WAL form) goes to
        insert and upsert only when given."""
        if kind == "insert":
            if meta is not None:
                return self.insert(vectors, ids, meta=meta)
            return self.insert(vectors, ids)
        if kind == "delete":
            return self.delete(ids)
        if kind == "upsert":
            if meta is not None:
                return self.upsert(vectors, ids, meta=meta)
            return self.upsert(vectors, ids)
        if kind == "compact":
            return self.compact()
        raise ValueError(
            f"unknown write kind {kind!r}; have {self.WRITE_KINDS}")


class _PlanLedger:
    """Plan bookkeeping: canonicalize the batch to the PLAN_BUCKETS ladder,
    count hit/miss per (engine, bucket, k, dtype, generation) plan key, pad
    the batch up to its bucket. It also owns the block schedules the
    grouped ADC grids build (``core.ivf.ScheduleCache``), which the engine
    keys by (bucket, generation, nprobe)."""

    def _plan_init(self):
        self.plan_buckets = PLAN_BUCKETS
        self.plan_generation = 0
        self._plans = set()
        self.plan_stats = {"hits": 0, "misses": 0}
        self.sched_cache = ScheduleCache()

    def _bucket(self, n: int) -> int:
        for b in self.plan_buckets:
            if n <= b:
                return b
        top = self.plan_buckets[-1]  # bulk path: next multiple of the cap
        return -(-n // top) * top

    def _plan_salt(self) -> tuple:
        return ()

    def _plan_batch(self, q, kk: int):
        """Record the plan key and pad q up to its bucket. Returns
        (padded q, original Q): padded rows repeat the last query, so the
        first Q result rows are unchanged and get sliced back out."""
        Q = q.shape[0]
        bucket = self._bucket(Q)
        key = (self.engine_name, bucket, kk, str(q.dtype),
               self.plan_generation) + self._plan_salt()
        if key in self._plans:
            self.plan_stats["hits"] += 1
        else:
            self.plan_stats["misses"] += 1
            self._plans.add(key)
        if bucket > Q:
            q = torch.cat([q, q[-1:].expand((bucket - Q,) + tuple(q.shape[1:]))])
        return q, Q


def _empty_result(Q: int, k: int, device):
    """(Q, 0)-shaped results for an empty index."""
    return (torch.zeros((Q, 0), dtype=torch.float32, device=device),
            torch.full((Q, 0), -1, dtype=torch.int32, device=device))


def _n_rows(vectors) -> int:
    shape = tuple(getattr(vectors, "shape", None) or np.shape(vectors))
    return shape[0] if len(shape) > 1 else 1


class VectorDB(_PlanLedger, _WriteFront):
    """Single-host front end over the engine registry. Single-writer,
    single-reader: queries and writes share the engine's buffers, so
    callers serialize access (the serving fronts run both on one
    thread)."""

    # engines whose query ANDs the predicate bitmap into its validity; the
    # reference's list also has ivf and int8 (ROADMAP.md Queue 1, item 5).
    # lsh's candidates come from hash probes, so a mask after the fact
    # would return fewer than k rows under a selective filter: it refuses.
    FILTERABLE = ("flat", "pq", "ivf_pq")

    def __init__(self, engine: str = "flat", metric: str = "cosine",
                 device=None, **engine_kwargs):
        if engine in PENDING_ENGINES:
            raise NotImplementedError(
                f"engine {engine!r} comes with ROADMAP.md Queue 1, item 5")
        if engine not in ENGINES:
            raise KeyError(f"unknown engine {engine!r}; have {sorted(ENGINES)}")
        if metric not in D.METRICS:
            raise ValueError(f"metric {metric!r} not in {D.METRICS}")
        self.engine_name = engine
        self.metric = metric
        self.device = resolve_device(device)
        self._engine_kwargs = dict(engine_kwargs)  # fresh-engine rebuilds
        self.index = self._new_engine()
        self.n = 0
        self._loaded = False
        self._texts = None
        self.wal = None  # attached by attach_wal / save_index(durable=True)
        self._wal_replaying = False
        # snapshot cadence (attach_wal): snapshot, and so truncate the log,
        # by its size or age, not only at explicit save_index calls
        self._snap_every_bytes = None
        self._snap_every_s = None
        self._snap_dir = None
        self._snap_bytes_mark = 0
        self._snap_t_mark = time.monotonic()
        self._snap_step = 0
        self._auto_snapshots = 0
        self.restore_stats = None  # set by restore_index
        # filtered and hybrid search: metadata columns keyed by slot id, an
        # optional frozen BM25 index, and the batch's filter context (crc32
        # of the predicate, nprobe boost) for the plan ledger
        self.metastore = MetadataStore()
        self.lexical = None
        self._filter_ctx = None
        self._filter_stats = {
            "filtered_batches": 0, "bitmap_build_ms": 0.0,
            "selectivity_hist": {"<=1%": 0, "<=10%": 0, "<=50%": 0,
                                 ">50%": 0},
            "hybrid_merges": 0, "nprobe_boosts": 0}
        self._plan_init()

    def _new_engine(self):
        return ENGINES[self.engine_name](metric=self.metric, device=self.device,
                                         **self._engine_kwargs)

    def _plan_salt(self) -> tuple:
        # the ADC grid mode and adaptive-nprobe masking each change the
        # search program on the same shapes; the filter context keeps
        # filtered batches apart in the ledger (a boosted nprobe is a
        # wider visit table)
        return (getattr(self.index, "adc_mode", None),
                getattr(self.index, "adaptive_nprobe", None),
                self._filter_ctx)

    def load(self, vectors, meta=None) -> "VectorDB":
        """Index a corpus. ``meta`` attaches metadata to rows 0..N-1: a
        columnar dict ({column: values}) or a list of row dicts (see
        ``search.meta``). A load is not logged (it precedes durability):
        its metadata rides snapshots."""
        vectors = torch.as_tensor(vectors, device=self.device)
        if vectors.dim() != 2:
            raise ValueError(f"load takes (N, d) vectors, got {tuple(vectors.shape)}")
        self.index.load(vectors)
        self.n = vectors.shape[0]
        self._loaded = True
        self.metastore = MetadataStore()  # a fresh corpus, a fresh id space
        if meta is not None:
            self.metastore.put(np.arange(self.n), meta)
        return self

    def load_texts(self, texts, encoder: Callable, batch_size: int = 128) -> "VectorDB":
        """Embed texts with ``encoder(list[str]) -> (B, d)`` then index
        them. The batches' embeddings are concatenated on the device."""
        embs = [torch.as_tensor(encoder(texts[i:i + batch_size]),
                                device=self.device)
                for i in range(0, len(texts), batch_size)]
        self._texts = list(texts)
        return self.load(torch.cat(embs, dim=0))

    def load_state(self, state) -> "VectorDB":
        """Serve a saved engine state: the engine's own ``state_dict`` or a
        reference state through ``core.convert.from_reference_state``;
        ``metastore__*`` leaves, where the state has them, become the
        metadata."""
        state = dict(state)
        store = MetadataStore.from_leaves(state)
        self.index.load_state(state)
        self.metastore = store
        self.n = self.index.size
        self._loaded = True
        return self

    # ----------------------------------------------------------- mutation
    def _mutate(self, op: str, *args, meta=None):
        if not self._loaded:
            raise RuntimeError(f"{op} before load")
        fn = getattr(self.index, op, None)
        if fn is None:
            raise NotImplementedError(
                f"engine {self.engine_name!r} does not support {op}")
        if meta is not None:  # a malformed batch is refused before it applies
            MetadataStore.normalize(range(_n_rows(args[0])), meta)
        before = getattr(self.index, "shape_key", None)
        out = fn(*args)
        if getattr(self.index, "shape_key", None) != before:
            # a buffer was reallocated: count the next query's plan as new
            self.plan_generation += 1
        self.n = self.index.size
        # metadata follows the ids the write produced: insert and upsert
        # attach rows (upsert replaces; an upsert without meta keeps the
        # old metadata, and replay makes the same choice), delete clears
        # presence, compact changes nothing (ids are stable addresses)
        norm_meta = None
        if meta is not None and op in ("insert", "upsert"):
            norm_meta = self.metastore.put(out, meta, replace=(op == "upsert"))
        elif op == "delete" and not self.metastore.empty:
            self.metastore.delete(args[0])
        if (self.wal is not None and not self._wal_replaying
                and op in WriteAheadLog.KINDS):
            self._wal_log(op, args, out, norm_meta)
            self._maybe_auto_snapshot()
        return out

    def _maybe_auto_snapshot(self) -> None:
        """The snapshot cadence after a logged write: past
        ``snapshot_every_bytes`` of log (or ``snapshot_every_s``) since the
        last snapshot, take a durable one, which truncates the log. Bounds
        replay time and the log's size under a pure write load."""
        if self._snap_every_bytes is None and self._snap_every_s is None:
            return
        grown = self.wal.bytes_written - self._snap_bytes_mark
        aged = time.monotonic() - self._snap_t_mark
        if ((self._snap_every_bytes is not None
             and grown >= self._snap_every_bytes)
                or (self._snap_every_s is not None
                    and aged >= self._snap_every_s)):
            self.save_index(self._snap_dir, self._snap_step + 1,
                            durable=True)
            self._auto_snapshots += 1

    def _wal_log(self, op: str, args, out, meta=None) -> None:
        """Append the applied write to the log. Insert logs the ids the
        engine assigned, so that replay re-applies them and the recovered
        id space is the same; ``meta`` is the normalized metadata that was
        stored. ``reserve`` is not logged: it changes no answer, and replay
        grows the buffers again."""
        if op == "insert":
            self.wal.append("insert", vectors=args[0], ids=out, meta=meta)
        elif op == "delete":
            self.wal.append("delete", ids=args[0])
        elif op == "upsert":
            self.wal.append("upsert", vectors=args[0], ids=args[1], meta=meta)
        elif op == "compact":
            self.wal.append("compact")

    def insert(self, vectors, ids=None, meta=None) -> torch.Tensor:
        """Append rows; returns their ids (int64, on the engine's device),
        assigned by a host counter and never reused. ``meta`` (a columnar
        dict or row dicts) attaches metadata at those ids."""
        return self._mutate("insert", vectors, ids, meta=meta)

    def delete(self, ids) -> int:
        """Tombstone rows by id; returns how many were live. Deleted slots
        read like pad slots until ``compact``; the ids stay retired."""
        return self._mutate("delete", ids)

    def upsert(self, vectors, ids, meta=None) -> torch.Tensor:
        """Re-encode existing ids in place (update or resurrect). With
        ``meta`` the rows' metadata is replaced whole; without it, kept."""
        return self._mutate("upsert", vectors, ids, meta=meta)

    def compact(self) -> dict:
        """Reclaim tombstoned query work (engine-specific; capacities are
        kept)."""
        return self._mutate("compact")

    def reserve(self, *args):
        """Pre-size the engine's buffers for a planned ingest volume; a
        reallocation is counted against the plan ledger here."""
        return self._mutate("reserve", *args)

    @property
    def mutation_stats(self):
        return getattr(self.index, "mutation_stats", None)

    @property
    def generation(self) -> int:
        return getattr(self.index, "generation", 0)

    # ----------------------------------------------------------- query
    def enable_lexical(self, texts=None, tokens=None, *,
                       vocab_size: int = 30_000, seq_len: int = 64,
                       k1: float = 1.5, b: float = 0.75) -> BM25Index:
        """Build the BM25 half of hybrid search over the indexed corpus
        (row i of ``texts``/``tokens`` is slot id i, the load order); the
        texts of ``load_texts`` by default. The index is frozen at build
        time: rebuild it after writes if new rows should match."""
        if texts is None and tokens is None:
            if self._texts is None:
                raise ValueError("enable_lexical needs texts or tokens (or "
                                 "a prior load_texts)")
            texts = self._texts
        if tokens is not None:
            self.lexical = BM25Index.from_tokens(tokens, k1=k1, b=b)
        else:
            self.lexical = BM25Index.from_texts(
                list(texts), vocab_size=vocab_size, seq_len=seq_len,
                k1=k1, b=b)
        return self.lexical

    def _filter_bitmap(self, where: Predicate):
        """Predicate -> (host bitmap over the id space, engine kwargs: the
        bitmap on the engine's device, and for ivf_pq the nprobe boost).
        Probing about 1/selectivity times more lists holds the count of
        candidates that pass the filter roughly steady; the boost is
        clamped to 4, as in the reference."""
        if self.engine_name not in self.FILTERABLE:
            raise NotImplementedError(
                f"engine {self.engine_name!r} does not support filtered "
                f"queries (have {self.FILTERABLE}; ivf and int8 come with "
                "ROADMAP.md Queue 1, item 5)")
        if not isinstance(where, Predicate):
            raise TypeError(f"where= takes a search.meta Predicate, got "
                            f"{type(where).__name__}")
        t0 = time.perf_counter()
        n_ids = int(getattr(self.index, "next_id", self.n) or self.n)
        allowed = self.metastore.mask(where, n_ids)
        fs = self._filter_stats
        fs["bitmap_build_ms"] += (time.perf_counter() - t0) * 1e3
        fs["filtered_batches"] += 1
        sel = float(allowed.sum()) / max(self.n, 1)
        hist = fs["selectivity_hist"]
        hist["<=1%" if sel <= 0.01 else "<=10%" if sel <= 0.10
             else "<=50%" if sel <= 0.50 else ">50%"] += 1
        extra = {"allowed": torch.as_tensor(allowed, device=self.device)}
        boost = 1
        if self.engine_name == "ivf_pq":
            boost = int(np.clip(np.round(1.0 / max(sel, 1e-9)), 1, 4))
            extra["nprobe_boost"] = boost
            if boost > 1:
                fs["nprobe_boosts"] += 1
        self._filter_ctx = (filter_hash(where), boost)
        return allowed, extra

    def _hybrid_fuse(self, scores, ids, alpha, texts, tokens, allowed,
                     kk: int):
        """Fuse the dense result with BM25 over the same queries (and the
        same predicate bitmap): ``search.lexical.hybrid_merge``, on the
        host; the result goes back to the engine's device."""
        if self.lexical is None:
            raise RuntimeError("hybrid query before enable_lexical(...)")
        Q = scores.shape[0]
        if tokens is None:
            if texts is None:
                raise ValueError(
                    "hybrid query needs hybrid_texts or hybrid_tokens")
            tokens = self.lexical.tokenize(list(texts))
        tokens = np.asarray(tokens)
        if tokens.shape[0] < Q:
            raise ValueError(f"{tokens.shape[0]} hybrid token rows for {Q} "
                             "queries")
        lex_s, lex_i = self.lexical.score(tokens[:Q], k=kk, allowed=allowed)
        self._filter_stats["hybrid_merges"] += 1
        s, i = hybrid_merge(scores.float().cpu().numpy(),
                            ids.cpu().numpy(), lex_s, lex_i,
                            alpha=float(alpha), k=kk)
        return (torch.as_tensor(s, device=self.device),
                torch.as_tensor(i, device=self.device))

    def query(self, q, k: int = 10, *, bucketize: bool = True, where=None,
              hybrid=None, hybrid_texts=None, hybrid_tokens=None):
        """q: (d,) or (Q, d) -> (scores (Q, k) f32, ids (Q, k) int32).

        ``bucketize`` pads Q up to the plan-bucket ladder; rows are
        independent in every engine, so the padded rows (repeats of the
        last query) cannot change the first Q results.

        ``where`` (a ``search.meta`` Predicate) restricts the results to
        matching rows: the predicate becomes one bitmap over the id space
        and filtered-out slots read like tombstones in the same kernels; an
        all-true bitmap gives the unfiltered answer bit for bit.
        ``hybrid=alpha`` fuses the dense scores with BM25 over
        ``hybrid_texts`` or ``hybrid_tokens`` (after ``enable_lexical``):
        alpha = 1 is dense only, 0 lexical only.
        """
        if not self._loaded:
            raise RuntimeError("query before load")
        # the plan is keyed on the caller's dtype, as the reference keys it;
        # float64 becomes float32 as jnp.asarray makes it (x64 off), and
        # each engine casts to the type it scores in
        q = torch.atleast_2d(torch.as_tensor(q, device=self.device))
        if q.dtype == torch.float64:
            q = q.float()
        kk = min(k, self.n)
        if kk <= 0:
            return _empty_result(q.shape[0], k, self.device)
        allowed, extra = None, {}
        self._filter_ctx = None
        if where is not None:
            allowed, extra = self._filter_bitmap(where)
        try:
            if bucketize:
                q, Q = self._plan_batch(q, kk)
                if hasattr(self.index, "sched_cache"):
                    # the engine completes the schedule key with its nprobe
                    self.index.sched_cache = self.sched_cache
                    self.index._sched_ctx = (self._bucket(Q),
                                             self.plan_generation)
            else:
                Q = q.shape[0]
            scores, ids = self.index.query(q, k=kk, **extra)
            scores, ids = scores[:Q], ids[:Q]
        finally:
            self._filter_ctx = None
        if hybrid is not None:
            scores, ids = self._hybrid_fuse(scores, ids, hybrid, hybrid_texts,
                                            hybrid_tokens, allowed, kk)
        return scores, ids

    def query_texts(self, texts, encoder: Callable, k: int = 10):
        """Embed the query texts and search -> (scores, ids, hits): hits
        are the loaded texts of each row's ids (None unless the corpus came
        through ``load_texts``)."""
        q = torch.as_tensor(encoder(list(texts)), device=self.device)
        scores, ids = self.query(q, k)
        if self._texts is not None:
            hits = [[self._texts[j] for j in row] for row in ids.tolist()]
            return scores, ids, hits
        return scores, ids, None

    # ----------------------------------------------------------- persistence
    def attach_wal(self, directory: str, fsync_interval_ms: float = 0.0,
                   *, after_lsn: int = 0, replay: bool = False,
                   snapshot_every_bytes: Optional[int] = None,
                   snapshot_every_s: Optional[float] = None) -> int:
        """Open (or create) ``<directory>/wal.log`` and log every write
        through it. ``replay=True`` first re-applies the intact records
        with lsn > after_lsn through ``apply_write`` (recovery), without
        logging them again. Returns the count replayed.

        ``snapshot_every_bytes`` / ``snapshot_every_s`` set the snapshot
        cadence: after a logged write that takes the log past the size (or
        age) bound since the last snapshot, a durable snapshot goes into
        ``directory`` and truncates the log (``wal_stats['auto_snapshots']``
        counts them). Needs an engine that snapshots."""
        if ((snapshot_every_bytes is not None or snapshot_every_s is not None)
                and getattr(self.index, "state_dict", None) is None):
            raise NotImplementedError(
                f"snapshot cadence needs persistence, which engine "
                f"{self.engine_name!r} does not support")
        path = os.path.join(directory, "wal.log")
        self.wal, records = WriteAheadLog.open(
            path, fsync_interval_ms=fsync_interval_ms, after_lsn=after_lsn)
        self._snap_every_bytes = snapshot_every_bytes
        self._snap_every_s = snapshot_every_s
        self._snap_dir = directory
        self._snap_bytes_mark = self.wal.bytes_written
        self._snap_t_mark = time.monotonic()
        steps = ckpt.valid_steps(directory)
        self._snap_step = max(steps) if steps else 0
        n = 0
        if replay:
            self._wal_replaying = True
            try:
                for rec in records:
                    self.apply_write(rec.kind, vectors=rec.vectors,
                                     ids=rec.ids, meta=rec.meta)
                    n += 1
            finally:
                self._wal_replaying = False
        return n

    def save_index(self, directory: str, step: int = 0, *,
                   durable: bool = False,
                   fsync_interval_ms: float = 0.0) -> str:
        """Snapshot the engine's state (``state_dict``: codebooks, codes,
        centroids, the live mask and generation) and the metadata columns
        through ``checkpoint.save``, in the reference's format.

        ``durable=True`` attaches (or keeps) the directory's write-ahead
        log: the manifest stamps the log's high-water mark ``wal_lsn``, and
        once the snapshot is committed the log is truncated to the records
        after it. A crash between the two is safe: restore skips records at
        or below the stamp."""
        state_dict = getattr(self.index, "state_dict", None)
        if state_dict is None:
            raise NotImplementedError(
                f"engine {self.engine_name!r} does not support persistence")
        if durable and self.wal is None:
            os.makedirs(directory, exist_ok=True)
            self.attach_wal(directory, fsync_interval_ms)
        if self.wal is not None:
            # the stamp means something only for the log beside the
            # snapshot: truncating a log elsewhere would strand its records
            # where no restore of this directory finds them
            expected = os.path.join(directory, "wal.log")
            if os.path.abspath(self.wal.path) != os.path.abspath(expected):
                raise ValueError(
                    f"save_index: WAL is attached at {self.wal.path!r} but "
                    f"the snapshot targets {directory!r}; write durable "
                    "snapshots to the WAL's own directory")
        meta = {"engine": self.engine_name, "metric": self.metric,
                "generation": int(self.generation),
                "live_rows": int(getattr(self.index, "size", self.n))}
        if self.wal is not None:
            self.wal.sync()  # the snapshot must not outrun the log
            meta["wal_lsn"] = int(self.wal.last_lsn)
        tree = dict(state_dict())
        tree.update(self.metastore.state_leaves())
        out = ckpt.save(tree, directory, step, meta=meta)
        if self.wal is not None:
            crashpoint("wal.truncate.pre")
            self.wal.truncate_through(meta["wal_lsn"])
            # explicit saves restart the snapshot cadence too
            self._snap_bytes_mark = self.wal.bytes_written
            self._snap_t_mark = time.monotonic()
            self._snap_step = max(self._snap_step, step)
        return out

    def restore_index(self, directory: str, step: Optional[int] = None, *,
                      durable: bool = False,
                      fsync_interval_ms: float = 0.0) -> "VectorDB":
        """Load a saved snapshot into this (fresh) VectorDB, every leaf
        straight into a tensor on the engine's device: no retraining,
        shapes from the manifest. A snapshot of a written index restores
        its tombstones and serves the same answers.

        Leftover ``step_<n>.tmp/`` directories never qualify, and a step
        whose manifest or files are missing, or that fails while loading,
        is skipped with a warning for the next latest valid step; when none
        loads, a RuntimeError lists what was tried. ``durable=True`` then
        attaches the directory's log and replays its records past the
        snapshot's ``wal_lsn``. ``restore_stats`` then holds the step, the
        seconds reading files (``read_s``), copying them into the device
        tensors (``upload_s``) and in all until the engine serves
        (``load_s``), the bytes read, and the records replayed and their
        seconds."""
        if getattr(self.index, "load_state", None) is None:
            raise NotImplementedError(
                f"engine {self.engine_name!r} does not support persistence")
        steps = [step] if step is not None else ckpt.valid_steps(directory)[::-1]
        if not steps:
            raise RuntimeError(
                f"no valid index snapshot to restore in {directory!r}")
        errors, chosen = [], None
        t_start = time.perf_counter()
        stats = {}
        for s in steps:
            def _skip(e):
                errors.append(f"step {s}: {type(e).__name__}: {e}")
                warnings.warn(f"restore_index: skipping snapshot step {s} "
                              f"({type(e).__name__}: {e})")
            try:
                # a torn npy, a missing file or a mangled manifest falls
                # back to an older step
                arrays = ckpt.load_arrays(directory, s, device=self.device,
                                          stats=stats)
            except (OSError, EOFError, KeyError, ValueError) as e:
                _skip(e)
                continue
            try:
                # the metadata leaves go first, so that the engine sees only
                # its own; a skipped step drops the half-built store
                store = MetadataStore.from_leaves(arrays)
                self.index.load_state(arrays)
                self.metastore = store
                chosen = s
                break
            # an engine's validation error (another metric or engine) would
            # refuse every step alike and propagates; a missing leaf skips
            except KeyError as e:
                _skip(e)
                del arrays
                # a partial load may have half-filled the engine
                self.index = self._new_engine()
        if chosen is None:
            raise RuntimeError(
                f"no loadable index snapshot in {directory!r} "
                f"(tried {list(steps)}): {'; '.join(errors)}")
        self.n = getattr(self.index, "size", 0)
        self._loaded = True
        stats.update(step=chosen, load_s=time.perf_counter() - t_start,
                     replayed=0, replay_s=0.0)
        if durable:
            snap_lsn = int(ckpt.load_meta(directory, chosen).get("wal_lsn", 0))
            t0 = time.perf_counter()
            stats["replayed"] = self.attach_wal(
                directory, fsync_interval_ms, after_lsn=snap_lsn, replay=True)
            stats["replay_s"] = time.perf_counter() - t0
        self.restore_stats = stats
        return self

    @property
    def wal_stats(self) -> Optional[dict]:
        """Durability counters (records, fsyncs, lsn marks, bytes, replayed
        and truncated, and the cadence's auto_snapshots) when a log is
        attached; None otherwise."""
        if self.wal is None:
            return None
        return dict(self.wal.stats, auto_snapshots=self._auto_snapshots)

    @property
    def filter_stats(self) -> Optional[dict]:
        """Filtered and hybrid query telemetry: filtered batches, the
        bitmaps' host build ms summed, the selectivity histogram, hybrid
        merges and ivf_pq's nprobe boosts; None before any such query."""
        fs = self._filter_stats
        if not (fs["filtered_batches"] or fs["hybrid_merges"]):
            return None
        return dict(fs, selectivity_hist=dict(fs["selectivity_hist"]))

    @property
    def adc_stats(self):
        """ADC grid-dispatch telemetry of an engine that keeps it (IVF-PQ):
        batches per grid, autotuner probes and crossover, sharing and
        effective-nprobe sums, and the schedule cache's hits and misses;
        None for other engines."""
        st = getattr(self.index, "adc_stats", None)
        if st is None:
            return None
        return dict(st, sched_cache_hits=self.sched_cache.stats["hits"],
                    sched_cache_misses=self.sched_cache.stats["misses"])
