"""Batched query serving for the vector DB: the synchronous pump front
(port of ``repro.serve.engine``).

Two fronts share this module's batching machinery:

  * ``QueryEngine`` (here): the caller's thread drives ``pump()``;
    ``submit`` returns a request id, results are polled by ``result``.
    Deterministic and single-threaded, it is the oracle the async front is
    tested against.
  * ``AsyncQueryEngine`` (``serve.async_engine``): thread-safe submission
    returning futures, a batcher thread that owns the DB and a completer
    thread that hands results back, overlapping host work with the card's.

Both assemble a read micro-batch the same way (``bucket_of``,
``assemble_queries``), pad it up to ``core.db.PLAN_BUCKETS``, and send
writes through ``VectorDB.apply_write`` (``apply_db_write``).

Ordering: writes share the queue with reads. Writes at the head apply at
once, and a read batch never reaches past the next queued write, so every
read sees exactly the writes submitted before it (read-your-writes) while
the reads between two writes still batch together.

A batch's results come back to the host in one copy (scores and ids, both
32-bit, packed into one tensor), the counterpart of the reference's one
``jax.device_get``. ``latency_stats`` reports enqueue-to-result p50/p99
with the DB's plan-ledger, mutation, write-ahead-log, ADC-dispatch and
filter counters.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.db import PLAN_BUCKETS

WRITE_KINDS = ("insert", "delete", "upsert", "compact")


@dataclasses.dataclass
class Request:
    rid: int
    query: object  # (d,) embedding (tensor or array), or token ids
    k: int = 10
    where: Optional[object] = None   # a search.meta predicate
    hybrid: Optional[float] = None   # BM25 fusion alpha
    text: Optional[str] = None       # raw query text for the lexical side
    t_enqueue: float = 0.0
    result: Optional[tuple] = None
    t_done: float = 0.0
    future: Optional[object] = None  # set by the async front only


@dataclasses.dataclass
class WriteRequest:
    rid: int
    kind: str  # one of WRITE_KINDS
    vectors: Optional[object] = None
    ids: Optional[object] = None
    t_enqueue: float = 0.0
    result: Optional[tuple] = None  # (kind, returned ids / count / stats)
    t_done: float = 0.0
    future: Optional[object] = None  # set by the async front only


# --------------------------------------------------------------- shared
def read_group(r: Request) -> tuple:
    """Batch-compatibility key of a read: reads co-batch only with the same
    predicate and hybrid alpha (``VectorDB.query`` takes one of each a
    batch). Both fronts close a read run at a change of group."""
    return (None if r.where is None else r.where.key(),
            None if r.hybrid is None else float(r.hybrid))


def bucket_of(n: int, buckets=PLAN_BUCKETS) -> int:
    """Smallest ladder bucket holding n requests (the top rung caps it)."""
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def assemble_queries(take: List[Request], bucket: int) -> torch.Tensor:
    """Stack a read micro-batch and pad it up to its bucket by repeating
    the last query: rows are independent in every engine, so the padding
    cannot change the first len(take) results."""
    q = torch.stack([torch.as_tensor(r.query) for r in take])
    if bucket > len(take):
        q = torch.cat([q, q[-1:].expand((bucket - len(take),)
                                         + tuple(q.shape[1:]))])
    return q


def query_kwargs(take: List[Request], n_rows: int) -> dict:
    """``VectorDB.query`` keyword arguments of a one-group read run: the
    shared predicate, and for hybrid the alpha and the batch's texts padded
    to ``n_rows`` by repeating the last."""
    head = take[0]
    kw = {}
    if head.where is not None:
        kw["where"] = head.where
    if head.hybrid is not None:
        texts = [r.text for r in take]
        texts += [texts[-1]] * (n_rows - len(texts))
        kw["hybrid"] = head.hybrid
        kw["hybrid_texts"] = texts
    return kw


def apply_db_write(db, kind: str, vectors=None, ids=None):
    """Route one write batch to the DB front: its ``apply_write`` entry
    point, or the four write methods of a front that has none."""
    fn = getattr(db, "apply_write", None)
    if fn is not None:
        return fn(kind, vectors=vectors, ids=ids)
    if kind == "insert":
        return db.insert(vectors, ids)
    if kind == "delete":
        return db.delete(ids)
    if kind == "upsert":
        return db.upsert(vectors, ids)
    if kind == "compact":
        return db.compact()
    raise ValueError(f"unknown write kind {kind!r}; have {WRITE_KINDS}")


def pack_results(scores: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """(2, Q, k) float32 of the scores and the int32 ids' bits, so that a
    batch crosses to the host in one copy."""
    return torch.stack([scores.float(), ids.to(torch.int32).view(torch.float32)])


def unpack_results(packed: torch.Tensor) -> tuple:
    """(scores (Q, k) float32, ids (Q, k) int32) of ``pack_results``."""
    return packed[0], packed[1].view(torch.int32)


def to_host(scores: torch.Tensor, ids: torch.Tensor) -> tuple:
    """A batch's results on the host: one copy from the card (none on the
    CPU)."""
    if scores.device.type == "cpu":
        return scores, ids
    return unpack_results(pack_results(scores, ids).cpu())


def summarize_latencies(latencies_ms, writes_applied: int, db,
                        extra: Optional[dict] = None) -> Dict[str, float]:
    """The one ``latency_stats`` body: enqueue-to-result percentiles, the
    DB's plan-ledger, mutation, write-ahead-log (``wal_*``: records
    against fsyncs is the group commit's amortization), ADC-dispatch and
    filter counters, and the async front's gauges in ``extra``."""
    if not latencies_ms and not writes_applied and not extra:
        return {}
    stats = {"engine": getattr(db, "engine_name", "?")}
    if latencies_ms:
        a = np.asarray(latencies_ms)
        stats.update({"p50_ms": float(np.percentile(a, 50)),
                      "p99_ms": float(np.percentile(a, 99)),
                      "mean_ms": float(a.mean()), "n": int(a.size)})
    plans = getattr(db, "plan_stats", None)
    if plans is not None:
        stats["plan_hits"] = int(plans["hits"])
        stats["plan_misses"] = int(plans["misses"])
    muts = getattr(db, "mutation_stats", None)
    if muts is not None:
        stats.update({f"write_{k}": int(v) for k, v in muts.items()})
    wal = getattr(db, "wal_stats", None)
    if wal is not None:
        stats.update({f"wal_{k}": int(v) for k, v in wal.items()})
    adc = getattr(db, "adc_stats", None)
    if adc is not None and adc.get("batches"):
        b = adc["batches"]
        stats["adc_blocked"] = int(adc["blocked"])
        stats["adc_per_query"] = int(adc["per_query"])
        stats["adc_run_resident"] = int(adc.get("run_resident", 0))
        stats["adc_probes"] = int(adc.get("probes", 0))
        if adc.get("crossover") is not None:
            stats["adc_crossover_sharing"] = float(adc["crossover"])
        if "sched_cache_hits" in adc:
            stats["adc_sched_cache_hits"] = int(adc["sched_cache_hits"])
            stats["adc_sched_cache_misses"] = int(adc["sched_cache_misses"])
        stats["adc_sharing_factor"] = float(adc["sharing_sum"] / b)
        stats["adc_effective_nprobe"] = float(adc["eff_nprobe_sum"] / b)
    flt = getattr(db, "filter_stats", None)
    if flt is not None:
        stats["filtered_batches"] = int(flt["filtered_batches"])
        stats["filter_bitmap_ms"] = float(flt["bitmap_build_ms"])
        stats["hybrid_merges"] = int(flt["hybrid_merges"])
        stats["filter_nprobe_boosts"] = int(flt["nprobe_boosts"])
        for kk, v in flt["selectivity_hist"].items():
            stats[f"filter_sel_{kk}"] = int(v)
    if extra:
        stats.update(extra)
    return stats


class QueryEngine:
    """The synchronous pump front (see the module docstring). Not
    thread-safe: one thread owns it and drives ``pump()``."""

    BUCKETS = PLAN_BUCKETS  # one ladder for encoder pads and DB query plans

    def __init__(self, db, *, encoder: Optional[Callable] = None,
                 max_batch: int = 64, max_wait_ms: float = 2.0):
        self.db = db
        self.encoder = encoder  # tokens -> embeddings; None = raw vectors
        self.max_batch = max_batch
        self.max_wait_ms = max_wait_ms
        self.queue: List = []  # Requests and WriteRequests, arrival order
        self.done: Dict[int, object] = {}
        self._next_id = 0
        self.latencies_ms: List[float] = []
        self.writes_applied = 0

    def submit(self, query, k: int = 10, *, where=None,
               hybrid: Optional[float] = None,
               text: Optional[str] = None) -> int:
        """Enqueue one read; returns the request id to poll by ``result``.
        Nothing runs until the next ``pump``."""
        if hybrid is not None and text is None:
            raise ValueError("hybrid submit needs the query text")
        rid = self._next_id
        self._next_id += 1
        self.queue.append(Request(rid, query, k, where, hybrid, text,
                                  time.perf_counter()))
        return rid

    def submit_write(self, kind: str, vectors=None, ids=None) -> int:
        """Enqueue a write batch (insert, delete, upsert, compact): reads
        submitted after it see it, reads submitted before it do not."""
        if kind not in WRITE_KINDS:
            raise ValueError(f"unknown write kind {kind!r}; have {WRITE_KINDS}")
        rid = self._next_id
        self._next_id += 1
        self.queue.append(WriteRequest(rid, kind, vectors, ids,
                                       time.perf_counter()))
        return rid

    def _apply_write(self, w: WriteRequest) -> None:
        out = apply_db_write(self.db, w.kind, w.vectors, w.ids)
        w.result = (w.kind, out)
        w.t_done = time.perf_counter()
        self.done[w.rid] = w
        self.writes_applied += 1

    def pump(self, *, force: bool = False) -> int:
        """Apply the writes at the head, then run one read micro-batch if
        due. Returns the number of reads served; the batch stops at the
        next queued write."""
        while self.queue and isinstance(self.queue[0], WriteRequest):
            self._apply_write(self.queue.pop(0))
        if not self.queue:
            return 0
        oldest_wait = (time.perf_counter() - self.queue[0].t_enqueue) * 1e3
        group = read_group(self.queue[0])
        n_reads = 0  # contiguous same-group run of reads at the head
        while (n_reads < len(self.queue) and n_reads < self.max_batch
               and isinstance(self.queue[n_reads], Request)
               and read_group(self.queue[n_reads]) == group):
            n_reads += 1
        # a write (or another group) right behind the run closes the batch:
        # waiting out max_wait_ms could not grow it
        closed = n_reads < len(self.queue) and n_reads < self.max_batch
        if (not force and not closed and n_reads < self.max_batch
                and oldest_wait < self.max_wait_ms):
            return 0
        take = self.queue[:n_reads]
        self.queue = self.queue[n_reads:]
        k = max(r.k for r in take)
        q = assemble_queries(take, bucket_of(len(take), self.BUCKETS))
        qv = self.encoder(q) if self.encoder is not None else q
        scores, ids = self.db.query(qv, k=k, **query_kwargs(take, len(q)))
        scores, ids = to_host(scores, ids)  # the batch's one copy
        t = time.perf_counter()
        for i, r in enumerate(take):
            r.result = (scores[i, : r.k], ids[i, : r.k])
            r.t_done = t
            self.done[r.rid] = r
            self.latencies_ms.append((t - r.t_enqueue) * 1e3)
        return len(take)

    def drain(self) -> int:
        served = 0
        while self.queue:
            served += self.pump(force=True)
        return served

    def result(self, rid: int):
        """A request's result, or None while pending: reads give (scores
        (k,), ids (k,)) on the host; writes (kind, the write's result)."""
        r = self.done.get(rid)
        return None if r is None else r.result

    def latency_stats(self) -> Dict[str, float]:
        """Enqueue-to-result p50/p99/mean of the served reads and the DB's
        counters; empty before anything resolved."""
        return summarize_latencies(self.latencies_ms, self.writes_applied,
                                   self.db)
