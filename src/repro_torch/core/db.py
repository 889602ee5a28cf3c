"""VectorDB: Thistle's load/query trait as the deployment API (port of
``repro.core.db``, the single-host path).

    db = VectorDB(engine="flat|ivf|graph|lsh|int8|pq|ivf_pq",
                  metric="cosine|l2|dot")
    db.load(vectors, meta=None)        # meta: the columns filters read
    scores, ids = db.query(q, k=10, where=None, hybrid=None)
    db.load_texts(texts, encoder)      # encoder(list[str]) -> (B, d)
    scores, ids, hits = db.query_texts(texts, encoder, k=10)
    ids = db.insert(new_vectors, meta=None)   # writes: flat, ivf, pq, ivf_pq
    db.delete(ids); db.upsert(vs, ids); db.compact(); db.reserve(n)
    db.save_index(dir, step, durable=True)    # flat, lsh, pq, ivf_pq
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

The mesh fronts (``DistributedVectorDB``, ``DistributedPQ``,
``DistributedIVFPQ``) serve ``flat``, ``pq`` and ``ivf_pq`` over a
``core.distributed.Mesh`` with the same plan ladder; ``DistributedIVFPQ``
takes writes through ``apply_write`` as ``VectorDB`` does, so that both
serving fronts serve either.
"""
from __future__ import annotations

import math
import os
import time
import warnings
from typing import Callable, Dict, Optional, Type

import numpy as np
import torch

from repro_torch import checkpoint as ckpt
from repro_torch import trace
from repro_torch.core import distances as D
from repro_torch.core import distributed as dist
from repro_torch.core.flat import (LOAD_CHUNK, FlatIndex, _check_snapshot,
                                   corpus_dtype)
from repro_torch.core.graph import GraphIndex
from repro_torch.core.ivf import (BlockListLayout, IVFIndex, ScheduleCache,
                                  assign_clusters)
from repro_torch.core.lsh import LSHIndex
from repro_torch.core.mutable import MutationMixin
from repro_torch.core.pq import (IVFPQIndex, PQIndex, _ivf_probe_stage,
                                 adc_tables, pq_encode, train_ivf_pq,
                                 train_pq)
from repro_torch.core.quant import Int8FlatIndex
from repro_torch.core.wal import WriteAheadLog
from repro_torch.device import resolve_device
from repro_torch.ft.faults import crashpoint
from repro_torch.kernels import ops as kops
from repro_torch.search.lexical import BM25Index, hybrid_merge
from repro_torch.search.meta import MetadataStore, Predicate, filter_hash

ENGINES: Dict[str, Type] = {
    "flat": FlatIndex,      # paper: Iterative (exact); the recall oracle
    "ivf": IVFIndex,        # paper: HNSW adaptation (a), coarse quantizer
    "graph": GraphIndex,    # paper: HNSW adaptation (b), graph beam search
    "lsh": LSHIndex,        # paper: LSH; Hamming shortlist + exact re-rank
    "int8": Int8FlatIndex,  # exact over an int8 corpus (a byte a dimension)
    "pq": PQIndex,          # product-quantized ADC scan (m bytes a row)
    "ivf_pq": IVFPQIndex,   # IVF buckets of PQ residuals + exact re-rank
}



def register_engine(name: str, cls: Type) -> None:
    """Add an engine under ``name`` (the reference's hook):
    ``VectorDB(name, metric=..., device=..., **kwargs)`` then builds
    ``cls(metric=metric, device=device, **kwargs)`` and serves it as it
    serves the built-in ones."""
    ENGINES[name] = cls


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

    # engines whose query ANDs the predicate bitmap into its validity (or
    # rewrites the rejected bucket slots to the pad sentinel). lsh's and
    # graph's candidates come from hash probes and beam walks, so a mask
    # after the fact would return fewer than k rows under a selective
    # filter: they refuse, as in the reference.
    FILTERABLE = ("flat", "int8", "ivf", "pq", "ivf_pq")

    def __init__(self, engine: str = "flat", metric: str = "cosine",
                 device=None, **engine_kwargs):
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
        bitmap on the engine's device, and for ivf and ivf_pq the nprobe
        boost).
        Probing about 1/selectivity times more lists holds the count of
        candidates that pass the filter roughly steady; the boost is
        clamped to 4, as in the reference."""
        if self.engine_name not in self.FILTERABLE:
            raise NotImplementedError(
                f"engine {self.engine_name!r} does not support filtered "
                f"queries (have {self.FILTERABLE})")
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
        if self.engine_name in ("ivf", "ivf_pq"):
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
        if trace.ON:
            trace.count("host_syncs", 2)   # the two copies to the host
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
        sp = trace.ON and trace.begin("db.query")
        try:
            if not self._loaded:
                raise RuntimeError("query before load")
            # the plan is keyed on the caller's dtype, as the reference keys
            # it; float64 becomes float32 as jnp.asarray makes it (x64 off),
            # and each engine casts to the type it scores in
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
                        # the engine completes the schedule key with its
                        # nprobe
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
                scores, ids = self._hybrid_fuse(scores, ids, hybrid,
                                                hybrid_texts, hybrid_tokens,
                                                allowed, kk)
            return scores, ids
        finally:
            if sp:
                trace.end(sp)

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
        if (getattr(self.index, "state_dict", None) is None
                or getattr(self.index, "load_state", None) is None):
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
        merges and ivf's and ivf_pq's nprobe boosts; None before any such
        query."""
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


# ---------------------------------------------------------------- mesh fronts
class _MeshFront(_PlanLedger):
    """What the three mesh fronts share: the mesh, the sharded axes and
    their row sharding, the plan ledger, and the merge device, where
    queries arrive and results come back (``device``, which the serving
    fronts read)."""

    def _mesh_init(self, mesh, metric: str, axes) -> None:
        if metric not in D.METRICS:
            raise ValueError(f"metric {metric!r} not in {D.METRICS}")
        self.mesh = mesh
        self.metric = metric
        self.sharding = dist.corpus_sharding(mesh, axes)
        self.axes = self.sharding.axes
        self.n_shards = self.sharding.n_shards
        self._plan_init()

    @property
    def device(self) -> torch.device:
        return self.mesh.merge_device

    def _queries(self, q, dtype=torch.float32):
        """q as a (Q, d) batch on the merge device: float32, cast to
        ``dtype``, normalized for cosine (in ``dtype``, as the reference
        normalizes after its cast); with the metric the shards score."""
        q = torch.atleast_2d(torch.as_tensor(q, device=self.device)).float()
        q = q.to(dtype)
        if self.metric == "cosine":
            return D.l2_normalize(q), "dot"
        return q, self.metric

    def _serve(self, q, kk: int, bucketize: bool, search):
        """Pad the batch to its plan bucket (or not), run ``search`` on it,
        slice the caller's rows back out; (Q, 0) results for kk = 0."""
        if kk <= 0:
            return _empty_result(q.shape[0], 0, self.device)
        Q = q.shape[0]
        if bucketize:
            q, Q = self._plan_batch(q, kk)
        s, i = search(q)
        return s[:Q], i[:Q]


def _slab_sq(slab):
    """|c|^2 of a slab's rows, float32, a chunk at a time."""
    out = torch.empty(slab.shape[0], dtype=torch.float32, device=slab.device)
    for a in range(0, slab.shape[0], LOAD_CHUNK):
        out[a:a + LOAD_CHUNK] = torch.sum(
            torch.square(slab[a:a + LOAD_CHUNK].float()), dim=-1)
    return out


class DistributedVectorDB(_MeshFront):
    """Exact search over a mesh (port of the reference's
    ``DistributedVectorDB``): corpus rows sharded over ``axes`` (every mesh
    axis by default), each shard's slab scanned by ``topk_distance`` on its
    device, the local top-k merged hierarchically
    (``core.distributed.sharded_flat_search``). ``dtype`` float32 or
    bfloat16 is the slabs' type; queries go through the plan-bucket ladder
    as on the single-host front.

    ``load`` builds each shard's (ceil(N / S), d) slab on its device
    (normalized for cosine; bf16 slabs a chunk of rows at a time, then
    cast), the last slab ending in the pad rows ``pad_to_shards`` would
    add: the caller's rows and the slabs are the only corpus-sized
    tensors, where padding the whole corpus first would make a third. For
    l2 each slab keeps its |c|^2, computed from the stored (cast) rows as
    the reference computes it each query. ``tile`` is taken at the
    reference's default only (``core.distributed.check_tile``).

    The slabs' rows are zero-padded to a multiple of 8 columns, the width
    the ``topk_distance`` kernel takes (``distances.pad_width``), at
    ``load`` and ``load_state``, and each query batch, as ``flat`` pads:
    zero columns change no score, so any width d serves. ``d`` is the
    rows' own width."""

    engine_name = "dist_flat"

    def __init__(self, mesh, metric: str = "cosine", axes=None,
                 dtype=torch.float32, tile: int = 65536):
        dist.check_tile(tile, 65536)
        self._mesh_init(mesh, metric, axes)
        self.dtype = corpus_dtype(dtype)
        self.corpus = self.valid = self.corpus_sq = None
        self.n = self.d = 0

    def _set_slabs(self, slabs, n: int) -> None:
        local_n = slabs[0].shape[0]
        self.corpus = dist.ShardedRows(slabs, self.sharding)
        self.valid = dist.ShardedRows(
            [idx * local_n + torch.arange(local_n, device=dev) < n
             for idx, dev in enumerate(self.sharding.devices)], self.sharding)
        self.corpus_sq = (dist.ShardedRows([_slab_sq(c) for c in slabs],
                                           self.sharding)
                          if self.metric == "l2" else None)
        self.n = int(n)

    def load(self, vectors) -> "DistributedVectorDB":
        x = torch.as_tensor(vectors)
        if x.dim() != 2:
            raise ValueError(f"load takes (N, d) vectors, got {tuple(x.shape)}")
        N, d = x.shape
        local_n = -(-N // self.n_shards)
        self.corpus = self.valid = self.corpus_sq = None
        slabs = []
        for idx, dev in enumerate(self.sharding.devices):
            base, stop = idx * local_n, min((idx + 1) * local_n, N)
            if self.dtype == torch.float32:
                # a slab's rows in one call, as FlatIndex preprocesses its
                # corpus: a (1,) mesh holds FlatIndex's rows bit for bit
                slab, _ = D.preprocess_corpus(
                    x[base:stop].to(device=dev, dtype=torch.float32),
                    self.metric)
                if stop - base < local_n:
                    slab = torch.cat([slab, slab.new_zeros(
                        (local_n - max(stop - base, 0), d))])
                slab = D.pad_width(slab)
            else:  # float32 rows a chunk at a time, as the bf16 FlatIndex
                slab = D.pad_width(torch.zeros((local_n, d), dtype=self.dtype,
                                               device=dev))
                for a in range(base, stop, LOAD_CHUNK):
                    b = min(a + LOAD_CHUNK, stop)
                    rows, _ = D.preprocess_corpus(
                        x[a:b].to(device=dev, dtype=torch.float32),
                        self.metric)
                    slab[a - base:b - base, :d] = rows
            slabs.append(slab)
        self._set_slabs(slabs, N)
        self.d = d
        return self

    def load_state(self, state) -> "DistributedVectorDB":
        """Serve a trained state (``core.convert.from_reference_state`` of a
        reference engine): the padded corpus, cut into this mesh's slabs
        (the same shard count as the state's mesh)."""
        _check_snapshot(state, self.engine_name, self.metric)
        got = corpus_dtype(state.get("dtype", self.dtype))
        if got != self.dtype:
            raise ValueError(f"state holds a {got} corpus, cannot load into "
                             f"a {self.dtype} mesh front")
        corpus = torch.as_tensor(state["corpus"]).to(self.dtype)
        if corpus.shape[0] % self.n_shards:
            raise ValueError(f"{corpus.shape[0]} padded rows do not split "
                             f"into {self.n_shards} shards")
        placed = self.sharding.place(D.pad_width(corpus))
        self._set_slabs(placed.shards, int(state["n"]))
        self.d = corpus.shape[1]
        return self

    def query(self, q, k: int = 10, *, bucketize: bool = True):
        """q: (d,) or (Q, d) -> (scores (Q, k) f32, ids (Q, k) int64) on
        the merge device."""
        if self.corpus is None:
            raise RuntimeError("query before load")
        qq, metric = self._queries(q, self.dtype)
        qq = D.pad_width(qq)
        return self._serve(qq, min(k, self.n), bucketize, lambda b: (
            dist.sharded_flat_search(
                self.corpus, b, mesh=self.mesh, k=min(k, self.n),
                metric=metric, axes=self.axes, valid=self.valid,
                corpus_sq=self.corpus_sq)))


class DistributedPQ(_MeshFront):
    """PQ serving over a mesh (port of the reference's ``DistributedPQ``):
    uint8 codes row-sharded, codebooks and the per-query (Q, m, ksub) LUTs
    replicated, each shard's N/S codes scanned by ``pq_adc`` on its device
    (``core.distributed.sharded_pq_search``). Training follows
    ``PQIndex.load`` step for step on the merge device; the corpus is not
    kept."""

    engine_name = "dist_pq"

    def __init__(self, mesh, metric: str = "cosine", m: int = 8,
                 ksub: int = 256, kmeans_iters: int = 10, seed: int = 0,
                 axes=None, use_kernel=None, lut_dtype: str = "float32"):
        self._mesh_init(mesh, metric, axes)
        if lut_dtype not in kops.ADC_LUT_DTYPES:
            raise ValueError(f"lut_dtype {lut_dtype!r} not in "
                             f"{kops.ADC_LUT_DTYPES}")
        self.m = m
        self.ksub = ksub
        self.kmeans_iters = kmeans_iters
        self.seed = seed
        self.use_kernel = use_kernel
        self.lut_dtype = lut_dtype
        self.codebooks = self.codes = self.valid = None
        self.n = 0
        self.d = 0

    def _set_codes(self, codes, n: int) -> None:
        codes, valid = dist.pad_to_shards(codes, self.n_shards)
        self.codes = self.sharding.place(codes)
        self.valid = self.sharding.place(valid)
        self.n = int(n)

    def load(self, vectors) -> "DistributedPQ":
        x = torch.as_tensor(vectors, dtype=torch.float32, device=self.device)
        self.n, self.d = x.shape
        corpus, _ = D.preprocess_corpus(x, self.metric)
        del x
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        self.codebooks = train_pq(corpus, m=self.m, ksub=self.ksub,
                                  iters=self.kmeans_iters, generator=gen)
        codes = pq_encode(self.codebooks, corpus)
        del corpus
        self._set_codes(codes, codes.shape[0])
        return self

    def load_state(self, state) -> "DistributedPQ":
        """Serve a trained state (``core.convert.from_reference_state``):
        codebooks, and the codes of the n rows (padding past n is
        ignored and made again for this mesh)."""
        _check_snapshot(state, self.engine_name, self.metric)
        self.codebooks = torch.as_tensor(state["codebooks"],
                                         device=self.device).float()
        self.m, self.ksub = (int(v) for v in self.codebooks.shape[:2])
        self.d = int(state["d"])
        n = int(state["n"])
        codes = torch.as_tensor(state["codes"], device=self.device)[:n]
        self._set_codes(codes.to(torch.uint8), n)
        return self

    def query(self, q, k: int = 10, *, bucketize: bool = True):
        """q: (d,) or (Q, d) -> (scores (Q, k) f32, ids (Q, k) int64) on
        the merge device."""
        if self.codes is None:
            raise RuntimeError("query before load")
        q, metric = self._queries(q)
        kk = min(k, self.n)

        def search(b):
            luts = adc_tables(self.codebooks, b, metric=metric)
            return dist.sharded_pq_search(
                self.codes, luts, mesh=self.mesh, k=kk, axes=self.axes,
                valid=self.valid, use_kernel=self.use_kernel,
                lut_dtype=self.lut_dtype)

        return self._serve(q, kk, bucketize, search)

    def per_device_bytes(self) -> int:
        """Resident index bytes a device: its code slab and the replicated
        codebooks (the reference's formula)."""
        return int(self.codes.numel() // self.n_shards
                   + self.codebooks.numel() * 4)

    def memory_bytes(self) -> int:
        return int(self.codes.numel()
                   + self.codebooks.numel() * 4 * self.n_shards)


class DistributedIVFPQ(_MeshFront, _WriteFront, MutationMixin):
    """IVF-PQ serving over a mesh (port of the reference's
    ``DistributedIVFPQ``): the block-aligned inverted lists range-sharded,
    each shard owning a contiguous range of (blk, m) code blocks plus its
    own all-pad block; centroids, codebooks and the block table
    replicated. The probe, the visit expansion (tails at -1) and the LUTs
    run once on the merge device (``core.pq._ivf_probe_stage``); each
    shard localizes the visit table to its range and runs the ``ivf_adc``
    grids on its slab (``core.distributed.sharded_ivf_pq_search``); the
    merge is the same as the other mesh fronts'. Bucket ids hold global
    rows. Compressed only: no re-rank, and no corpus is kept after load.

    Writes, as the reference takes them, over one ``BlockListLayout`` on
    the merge device whose capacity is a multiple of the shard count
    (``row_multiple``), so that storage rows slice into equal slabs. A
    new block takes the lowest free row, which is the row the reference's
    allocation policy (the shard of the cluster's last block while it has
    a free row, else the lowest free row) picks: see
    ``core.ivf.BlockListLayout``. Deletes tombstone slots to the -1 every
    grid knocks out. After each write the slabs are cut again
    (``_sync``); a capacity growth moves the shard boundaries, as in the
    reference. Load trains through ``core.pq.train_ivf_pq``, so one seed
    gives the clustering of ``VectorDB("ivf_pq")``."""

    engine_name = "dist_ivf_pq"

    def __init__(self, mesh, metric: str = "cosine", n_clusters: int = 0,
                 nprobe: int = 8, m: int = 8, ksub: int = 256,
                 kmeans_iters: int = 10, seed: int = 0, axes=None,
                 use_kernel=None, lut_dtype: str = "float32",
                 block_size: int = 32):
        self._mesh_init(mesh, metric, axes)
        if lut_dtype not in kops.ADC_LUT_DTYPES:
            raise ValueError(f"lut_dtype {lut_dtype!r} not in "
                             f"{kops.ADC_LUT_DTYPES}")
        self.n_clusters = n_clusters  # 0 => sqrt(N) at load time
        self.nprobe = nprobe
        self.m = m
        self.ksub = ksub
        self.kmeans_iters = kmeans_iters
        self.seed = seed
        self.use_kernel = use_kernel
        self.lut_dtype = lut_dtype
        self.block_size = block_size
        self.codebooks = self.centroids = None
        self.codes_bm = self.bucket_ids = self.block_table = None
        self.layout = None
        self.spp = 1
        self.blocks_per_shard = 0
        self.n = 0  # id-space size; `size` is the live count
        self.d = 0
        self._mut_init(0)

    @property
    def size(self) -> int:
        return 0 if self.layout is None else int(self.layout.live)

    def _new_layout(self, codes, assign, n_clusters: int) -> None:
        self.layout = BlockListLayout.from_assign(
            assign, n_clusters, blk=self.block_size, payload=codes,
            row_multiple=self.n_shards)

    def load(self, vectors) -> "DistributedIVFPQ":
        x = torch.as_tensor(vectors, dtype=torch.float32, device=self.device)
        N, self.d = x.shape
        C = min(self.n_clusters or max(1, int(math.sqrt(N))), N)
        corpus, _ = D.preprocess_corpus(x, self.metric)
        del x
        self.centroids, assign, self.codebooks, codes = train_ivf_pq(
            corpus, n_clusters=C, m=self.m, ksub=self.ksub,
            iters=self.kmeans_iters, metric=self.metric, seed=self.seed)
        del corpus
        self._new_layout(codes, assign, C)
        self.n = N
        self._mut_init(N)
        self._sync()
        return self

    def load_state(self, state) -> "DistributedIVFPQ":
        """Serve a trained and maybe written state
        (``core.convert.from_reference_state`` of a reference engine):
        codebooks, centroids and the layout array for array
        (``BlockListLayout.from_arrays``), with the id space, generation
        and write counters."""
        _check_snapshot(state, self.engine_name, self.metric)
        dev = self.device
        self.codebooks = torch.as_tensor(state["codebooks"], device=dev).float()
        self.centroids = torch.as_tensor(state["centroids"], device=dev).float()
        self.m, self.ksub = (int(v) for v in self.codebooks.shape[:2])
        self.d = int(state["d"])
        arrays = {key[len("layout_"):]: value for key, value in state.items()
                  if key.startswith("layout_")}
        self.layout = BlockListLayout.from_arrays(
            arrays, device=dev, row_multiple=self.n_shards)
        self.block_size = self.layout.blk
        self._mut_init(int(state["next_id"]))
        self.n = self.next_id
        self.generation = int(state.get("generation", 0))
        for kind in self.mutation_stats:
            self.mutation_stats[kind] = int(state.get(f"writes_{kind}", 0))
        self._sync()
        return self

    # ---------------------------------------------------------- mutation
    def _encode_batch(self, vectors):
        x = torch.atleast_2d(torch.as_tensor(vectors, dtype=torch.float32,
                                             device=self.device))
        rows, _ = D.preprocess_corpus(x, self.metric)
        assign = assign_clusters(rows, self.centroids)
        return pq_encode(self.codebooks, rows - self.centroids[assign]), assign

    def _after_mutation(self, shape_before) -> None:
        if self.layout.shape_key != shape_before:
            self.plan_generation += 1

    def insert(self, vectors, ids=None) -> torch.Tensor:
        codes, assign = self._encode_batch(vectors)
        ids = self._take_ids(codes.shape[0], ids)
        before = self.layout.shape_key
        self.layout.insert_rows(ids, assign, codes)
        self.n = self.next_id
        self._record("inserts", ids.numel())
        self._after_mutation(before)
        return ids

    def delete(self, ids) -> int:
        n = self.layout.delete_rows(ids)
        if n:
            self._record("deletes", n)
        return n

    def upsert(self, vectors, ids) -> torch.Tensor:
        codes, assign = self._encode_batch(vectors)
        ids = self._check_upsert_ids(codes.shape[0], ids)
        before = self.layout.shape_key
        self.layout.delete_rows(ids)
        self.layout.insert_rows(ids, assign, codes)
        self._record("upserts", ids.numel())
        self._after_mutation(before)
        return ids

    def compact(self) -> dict:
        stats = self.layout.compact()
        self._record("compactions", 1)
        return stats

    # ------------------------------------------------------------- query
    def _sync(self) -> None:
        """Cut the layout into the shards' slabs: shard s gets storage rows
        [s * bloc, (s + 1) * bloc) and one all-pad block after them, on its
        device (bloc = capacity / S, the blocks a shard owns)."""
        if not self._dirty:
            return
        lay = self.layout
        S, blk = self.n_shards, lay.blk
        bloc = lay.capacity // S
        self.codes_bm = self.bucket_ids = None  # the old slabs go first
        slots = lay.slots.view(S, bloc, blk)
        codes = lay.codes.view(S, bloc, blk, self.m)
        ids, cds = [], []
        for s, dev in enumerate(self.sharding.devices):
            ids.append(torch.cat([slots[s], slots.new_full((1, blk), -1)]
                                 ).to(dev))
            cds.append(torch.cat([codes[s],
                                  codes.new_zeros((1, blk, self.m))]).to(dev))
        self.bucket_ids = dist.ShardedRows(ids, self.sharding)
        self.codes_bm = dist.ShardedRows(cds, self.sharding)
        self.block_table = lay.block_table
        self.spp = lay.steps_per_probe
        self.blocks_per_shard = bloc
        self._dirty = False

    def query(self, q, k: int = 10, *, bucketize: bool = True):
        """q: (d,) or (Q, d) -> (scores (Q, k) f32, ids (Q, k) int64) on
        the merge device; (-inf, -1) past the live candidates."""
        if self.layout is None:
            raise RuntimeError("query before load")
        self._sync()
        q, metric = self._queries(q)
        kk = min(k, max(self.size, 1))
        nprobe = min(self.nprobe, self.centroids.shape[0])

        def search(b):
            visit, luts, coarse, _ = _ivf_probe_stage(
                self.codebooks, self.centroids, b, self.block_table,
                metric=metric, nprobe=nprobe, steps_per_probe=self.spp,
                pad_block=-1)
            return dist.sharded_ivf_pq_search(
                self.codes_bm, self.bucket_ids, visit, luts, coarse,
                mesh=self.mesh, k=kk, steps_per_probe=self.spp,
                blocks_per_shard=self.blocks_per_shard, axes=self.axes,
                use_kernel=self.use_kernel, lut_dtype=self.lut_dtype)

        return self._serve(q, kk, bucketize, search)

    def per_device_bytes(self) -> int:
        """Resident index bytes a device: its block slab (codes and slot
        ids) and the replicated coarse structures (the reference's
        formula)."""
        S = self.n_shards
        return int(self.codes_bm.numel() // S
                   + self.bucket_ids.numel() * 4 // S
                   + self.codebooks.numel() * 4 + self.centroids.numel() * 4
                   + self.block_table.numel() * 4)
