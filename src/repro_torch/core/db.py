"""VectorDB: Thistle's load/query trait as the deployment API (port of
``repro.core.db``, the single-host path).

    db = VectorDB(engine="flat|pq|ivf_pq|lsh", metric="cosine|l2|dot")
    db.load(vectors)
    scores, ids = db.query(q, k=10)
    db.load_texts(texts, encoder)      # encoder(list[str]) -> (B, d)
    scores, ids, hits = db.query_texts(texts, encoder, k=10)
    ids = db.insert(new_vectors)       # online mutation (flat, pq, ivf_pq)
    db.delete(ids); db.upsert(vs, ids); db.compact(); db.reserve(n)

The front canonicalizes each batch to the ``PLAN_BUCKETS`` ladder and
counts plan hits and misses as the reference does, so that the serving
layer reads the same counters; padded rows repeat the last query and are
sliced off again. Writes go to the engine (``core.mutable``); when one
changes the engine's ``shape_key`` (a buffer was reallocated),
``plan_generation`` bumps and the next query counts a plan miss. Entry
points run on the GPU unless given ``device="cpu"``.
"""
from __future__ import annotations

from typing import Callable, Dict, Type

import torch

from repro_torch.core import distances as D
from repro_torch.core.flat import FlatIndex
from repro_torch.core.ivf import ScheduleCache
from repro_torch.core.lsh import LSHIndex
from repro_torch.core.pq import IVFPQIndex, PQIndex
from repro_torch.device import resolve_device

ENGINES: Dict[str, Type] = {
    "flat": FlatIndex,      # paper: Iterative (exact); the recall oracle
    "pq": PQIndex,          # product-quantized ADC scan (m bytes a row)
    "ivf_pq": IVFPQIndex,   # IVF buckets of PQ residuals + exact re-rank
    "lsh": LSHIndex,        # paper: LSH; Hamming shortlist + exact re-rank
}

# plan bucket ladder: batches pad up to the next bucket
PLAN_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512)


class _WriteFront:
    """The serving layer's single write entry point: one call dispatches
    any of the four write kinds, so that both serving fronts share one
    write body. Not thread-safe, like the writes themselves: the fronts
    serialize writes and queries on one thread."""

    WRITE_KINDS = ("insert", "delete", "upsert", "compact")

    def apply_write(self, kind: str, vectors=None, ids=None, meta=None):
        """Apply one write batch by kind. Returns the write's own result:
        the ids (insert, upsert), the live rows deleted (delete) or the
        stats dict (compact)."""
        if meta is not None:
            raise NotImplementedError(
                "metadata comes with filtered search (ROADMAP.md Queue 1, "
                "item 4)")
        if kind == "insert":
            return self.insert(vectors, ids)
        if kind == "delete":
            return self.delete(ids)
        if kind == "upsert":
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


class VectorDB(_PlanLedger, _WriteFront):
    """Single-host front end over the engine registry. Single-writer,
    single-reader: queries and writes share the engine's buffers, so
    callers serialize access (the serving fronts run both on one
    thread)."""

    def __init__(self, engine: str = "flat", metric: str = "cosine",
                 device=None, **engine_kwargs):
        if engine not in ENGINES:
            raise KeyError(f"unknown engine {engine!r}; have {sorted(ENGINES)}")
        if metric not in D.METRICS:
            raise ValueError(f"metric {metric!r} not in {D.METRICS}")
        self.engine_name = engine
        self.metric = metric
        self.device = resolve_device(device)
        self.index = ENGINES[engine](metric=metric, device=self.device,
                                     **engine_kwargs)
        self.n = 0
        self._loaded = False
        self._texts = None
        self._plan_init()

    def _plan_salt(self) -> tuple:
        # the ADC grid mode and adaptive-nprobe masking each change the
        # search program on the same shapes
        return (getattr(self.index, "adc_mode", None),
                getattr(self.index, "adaptive_nprobe", None))

    def load(self, vectors) -> "VectorDB":
        vectors = torch.as_tensor(vectors, device=self.device)
        if vectors.dim() != 2:
            raise ValueError(f"load takes (N, d) vectors, got {tuple(vectors.shape)}")
        self.index.load(vectors)
        self.n = vectors.shape[0]
        self._loaded = True
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
        reference state through ``core.convert.from_reference_state``."""
        self.index.load_state(state)
        self.n = self.index.size
        self._loaded = True
        return self

    # ----------------------------------------------------------- mutation
    def _mutate(self, op: str, *args, meta=None):
        if meta is not None:
            raise NotImplementedError(
                "metadata comes with filtered search (ROADMAP.md Queue 1, "
                "item 4)")
        if not self._loaded:
            raise RuntimeError(f"{op} before load")
        fn = getattr(self.index, op, None)
        if fn is None:
            raise NotImplementedError(
                f"engine {self.engine_name!r} does not support {op}")
        before = getattr(self.index, "shape_key", None)
        out = fn(*args)
        if getattr(self.index, "shape_key", None) != before:
            # a buffer was reallocated: count the next query's plan as new
            self.plan_generation += 1
        self.n = self.index.size
        return out

    def insert(self, vectors, ids=None, meta=None) -> torch.Tensor:
        """Append rows; returns their ids (int64, on the engine's device),
        assigned by a host counter and never reused."""
        return self._mutate("insert", vectors, ids, meta=meta)

    def delete(self, ids) -> int:
        """Tombstone rows by id; returns how many were live. Deleted slots
        read like pad slots until ``compact``; the ids stay retired."""
        return self._mutate("delete", ids)

    def upsert(self, vectors, ids, meta=None) -> torch.Tensor:
        """Re-encode existing ids in place (update or resurrect)."""
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
    def query(self, q, k: int = 10, *, bucketize: bool = True, where=None,
              hybrid=None, hybrid_texts=None):
        """q: (d,) or (Q, d) -> (scores (Q, k) f32, ids (Q, k) int32).

        ``bucketize`` pads Q up to the plan-bucket ladder; rows are
        independent in every engine, so the padded rows (repeats of the
        last query) cannot change the first Q results.
        """
        if where is not None or hybrid is not None or hybrid_texts is not None:
            raise NotImplementedError(
                "filtered and hybrid search come with ROADMAP.md Queue 1, "
                "item 4")
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
        if bucketize:
            q, Q = self._plan_batch(q, kk)
            if hasattr(self.index, "sched_cache"):
                # the engine completes the schedule key with its nprobe
                self.index.sched_cache = self.sched_cache
                self.index._sched_ctx = (self._bucket(Q),
                                         self.plan_generation)
        else:
            Q = q.shape[0]
        scores, ids = self.index.query(q, k=kk)
        return scores[:Q], ids[:Q]

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
