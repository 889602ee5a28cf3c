"""Async continuous-batching serving front (port of
``repro.serve.async_engine``).

``QueryEngine`` (``serve.engine``) is a pump loop on the caller's thread:
assemble, score, copy back, scatter, one after the other.
``AsyncQueryEngine`` splits that into threads so that host work overlaps
the card's::

    submitters (any threads)          batcher thread              completer thread
    ------------------------          --------------              ----------------
    submit()/submit_write()  --> [bounded request queue] -->  assemble + db.query
         returns Future                (backpressure)         + the copy to pinned
                                                                host memory issued
                                                          --> [inflight queue] -->
                                                               wait on the copy's
                                                               event + scatter +
                                                               future.set_result

  * **Submitters** enqueue ``Request``/``WriteRequest`` jobs carrying a
    ``concurrent.futures.Future`` into one bounded FIFO (``max_queue``).
    ``overflow="block"`` makes ``submit`` wait (optionally with a
    timeout), ``"reject"`` makes it raise ``BackpressureError`` at once.
  * **The batcher thread** is the only thread that touches the DB. It
    drains the queue in arrival order: writes apply at once through the
    DB's ``apply_write`` (``VectorDB``'s or ``DistributedIVFPQ``'s); reads gather into a micro-batch until
    ``max_batch``, ``max_wait_ms`` or the next write (a write closes the
    batch: read-your-writes, as in the pump). It pads the batch to the
    ``PLAN_BUCKETS`` ladder, moves it to the card through pinned memory
    without blocking, and calls ``db.query``, whose kernels the card runs
    asynchronously (``adc_mode="auto"`` syncs once a batch, in its sharing
    probe); then it issues the copy of the scores and ids
    into pinned host memory (``non_blocking``) on a stream of its own,
    ordered after the query, records a CUDA event there, and goes on to
    the next batch while the card works.
  * **The completer thread** waits on that event only, never on the
    device as a whole: ``torch.cuda.synchronize()`` or a plain ``.cpu()``
    on the shared default stream would queue behind the next batch's
    kernels and leave no overlap. It scatters the results into the
    futures and records enqueue-to-result latencies. On the CPU there is
    no event: ``db.query`` has already finished.

``max_inflight`` bounds the batches between dispatch and completion with
a semaphore: the batcher takes a slot before it fills a batch and the
completer returns it once the copy has landed, so while the batcher
waits for a slot, arrivals ride along in the next batch. Writes edit the
engine's buffers in place on the same stream as the queries, after the
kernels of every batch already dispatched, and the results of those
batches are tensors of their own: a write never changes a dispatched
batch's answer.

Group commit: on a DB with a write-ahead log, a write's future resolves
only once the fsync that covers its record is done. ``fsync_interval_ms``
sets the log's policy (0: an fsync a record; > 0: appends within the
window share one fsync); the batcher holds the acks of records not yet
fsync'd in ``_wal_pending`` and flushes at the window's deadline, also
while it waits for work (``_get_job``), and at shutdown. A DB without a
log refuses ``fsync_interval_ms``.

``latency_stats`` adds the gauges ``queue_depth``, ``queue_depth_max``,
``rejected``, ``inflight`` and ``durable_pending`` (acks held for an
fsync) to the shared summary.
"""
from __future__ import annotations

import collections
import itertools
import queue
import threading
import time
from concurrent.futures import Future
from typing import Callable, List, Optional

import torch

from repro_torch import trace
from repro_torch.core.db import PLAN_BUCKETS
from repro_torch.serve.engine import (WRITE_KINDS, Request, WriteRequest,
                                      apply_db_write, assemble_queries,
                                      bucket_of, pack_results, query_kwargs,
                                      read_group, summarize_latencies,
                                      unpack_results)


def _record_queue_waits(batch: List[Request], inflight: int) -> None:
    """A ``front.queue`` span of each request of the batch, from its
    ``submit`` to the start of the batch's ``front.inflight`` (the start
    of its ``db.query``), pointing at that span."""
    t1 = trace.span_start(inflight)
    for r in batch:
        trace.record("front.queue", int(r.t_enqueue * 1e9), t1,
                     parent=inflight, key=r.rid)


class BackpressureError(RuntimeError):
    """The bounded request queue is full (policy "reject", or "block" with
    an expired timeout): the caller sheds load or retries later."""


_SENTINEL = object()  # queue terminator: close() enqueues it last


class _BoundedFIFO:
    """Bounded FIFO for continuous batching: ``pop_ready`` hands the
    batcher every queued job in one lock acquisition, and ``put`` returns
    the depth after the insert for the queue-depth gauge."""

    def __init__(self, maxsize: int):
        self.maxsize = maxsize
        self._d = collections.deque()
        mu = threading.Lock()
        self._not_empty = threading.Condition(mu)
        self._not_full = threading.Condition(mu)

    def put(self, item, timeout: Optional[float] = None) -> int:
        """Append; blocks while full (timeout=0: at once). Raises
        ``queue.Full`` on timeout; returns the new depth."""
        with self._not_full:
            if len(self._d) >= self.maxsize:
                if timeout == 0 or not self._not_full.wait_for(
                        lambda: len(self._d) < self.maxsize, timeout):
                    raise queue.Full
            self._d.append(item)
            self._not_empty.notify()
            return len(self._d)

    def get(self, timeout: Optional[float] = None):
        """Pop one job, blocking up to timeout; raises ``queue.Empty``."""
        with self._not_empty:
            if not self._not_empty.wait_for(lambda: self._d, timeout):
                raise queue.Empty
            item = self._d.popleft()
            self._not_full.notify_all()
            return item

    def put_block(self, items: list, timeout: Optional[float] = None) -> int:
        """Append a block contiguously in one acquisition, blocking until
        the bound admits all of it (each item counts toward maxsize).
        Raises ``queue.Full`` on timeout; returns the new depth."""
        with self._not_full:
            if not self._not_full.wait_for(
                    lambda: len(self._d) + len(items) <= self.maxsize,
                    timeout):
                raise queue.Full
            self._d.extend(items)
            self._not_empty.notify()
            return len(self._d)

    def pop_ready(self, max_n: int) -> list:
        """Everything queued now, up to max_n, in one acquisition."""
        with self._not_empty:
            n = min(max_n, len(self._d))
            items = [self._d.popleft() for _ in range(n)]
            if n:
                self._not_full.notify_all()
            return items

    def qsize(self) -> int:
        return len(self._d)  # atomic under the GIL; a gauge


class AsyncQueryEngine:
    """Thread-safe continuous-batching front (see the module docstring).

    ``submit`` / ``submit_write`` may be called from any number of threads;
    each returns a Future resolving to what ``QueryEngine.result`` gives.
    Execution follows queue arrival order, so within one submitter thread a
    read submitted after a write sees it and one submitted before does
    not. The DB is touched by the batcher thread only: callers must not
    query or write it directly while the engine runs.

    Shutdown: ``close(drain=True)`` (also the context manager's exit)
    stops intake, serves everything queued and joins both threads;
    ``close(drain=False)`` cancels the queued jobs instead (dispatched
    batches still complete).
    """

    BUCKETS = PLAN_BUCKETS

    def __init__(self, db, *, encoder: Optional[Callable] = None,
                 max_batch: int = 64, max_wait_ms: float = 2.0,
                 max_queue: int = 1024, overflow: str = "block",
                 max_inflight: int = 2, start: bool = True,
                 fsync_interval_ms: Optional[float] = None):
        if overflow not in ("block", "reject"):
            raise ValueError(f"overflow {overflow!r} not in (block, reject)")
        if fsync_interval_ms is not None:
            wal = getattr(db, "wal", None)
            if wal is None:
                raise ValueError("fsync_interval_ms needs a durable DB with a "
                                 "write-ahead log (save_index or "
                                 "restore_index with durable=True first)")
            wal.fsync_interval_ms = float(fsync_interval_ms)
        self._wal_pending: List[WriteRequest] = []  # applied, awaiting fsync
        self._wal_deadline = 0.0     # batcher's, armed on the first held ack
        self._durable_pending = 0    # len(_wal_pending), under _lock
        self.db = db
        self.encoder = encoder  # tokens -> embeddings; None = raw vectors
        self.max_batch = max_batch
        self.max_wait_ms = max_wait_ms
        self.max_queue = max_queue
        self.overflow = overflow
        self._requests = _BoundedFIFO(max_queue)
        self._pending: "collections.deque" = collections.deque()  # batcher's
        self._inflight: "queue.Queue" = queue.Queue()
        self.max_inflight = max_inflight
        self._slots = threading.Semaphore(max_inflight)
        self._copy_stream = None  # the batcher's stream for result copies
        self._lock = threading.Lock()
        self._idle = threading.Condition(self._lock)
        self._outstanding = 0  # accepted jobs whose future is not resolved
        self._rid = itertools.count()
        self.latencies_ms: List[float] = []
        self.writes_applied = 0
        self.rejected = 0
        self.queue_depth_max = 0
        self._closed = False
        self._discard = threading.Event()  # close(drain=False): cancel jobs
        self._batcher = self._completer = None
        if start:
            self.start()

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "AsyncQueryEngine":
        """Start (or restart after close) the batcher and completer. Jobs
        submitted while stopped wait in the queue until then."""
        if self._batcher is not None:
            return self
        with self._lock:
            self._closed = False
        self._discard.clear()
        self._slots = threading.Semaphore(self.max_inflight)
        self._completer = threading.Thread(
            target=self._complete_loop, name="serve-completer", daemon=True)
        self._batcher = threading.Thread(
            target=self._batch_loop, name="serve-batcher", daemon=True)
        self._completer.start()
        self._batcher.start()
        return self

    def close(self, drain: bool = True, timeout: Optional[float] = None) -> None:
        """Stop intake and shut the pipeline down (see the class
        docstring)."""
        with self._lock:
            if self._closed and self._batcher is None:
                return
            self._closed = True
        if not drain:
            self._discard.set()
        if self._batcher is None:  # never started: nothing will drain it
            self._cancel_queued()
            return
        self._requests.put(_SENTINEL)  # after every accepted job (FIFO)
        self._batcher.join(timeout)
        self._completer.join(timeout)
        self._batcher = self._completer = None
        self._cancel_queued()  # stragglers that raced the closed check

    def __enter__(self) -> "AsyncQueryEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close(drain=True)

    def _cancel_queued(self) -> None:
        while True:
            jobs = self._requests.pop_ready(self.max_queue + 1)
            if not jobs:
                return
            for job in jobs:
                if job is not _SENTINEL:
                    job.future.cancel()
                    self._resolve_one()

    # ----------------------------------------------------------- submission
    def _enqueue(self, job, timeout: Optional[float]) -> Future:
        if self._closed:
            raise RuntimeError("submit after close")
        job.rid = next(self._rid)
        with self._idle:  # count before put: a job never resolves to -1
            self._outstanding += 1
        try:
            depth = self._requests.put(
                job, timeout=0 if self.overflow == "reject" else timeout)
        except queue.Full:
            self._resolve_one()  # roll the accept back
            with self._lock:
                self.rejected += 1
            msg = (f"request queue full ({self.max_queue}); shed load or "
                   "use overflow='block'" if self.overflow == "reject" else
                   f"request queue full ({self.max_queue}) after {timeout}s")
            raise BackpressureError(msg) from None
        if depth > self.queue_depth_max:  # benign race: high-water gauge
            self.queue_depth_max = depth
        return job.future

    def submit(self, query, k: int = 10, timeout: Optional[float] = None, *,
               where=None, hybrid: Optional[float] = None,
               text: Optional[str] = None) -> Future:
        """Thread-safe read; the Future resolves to (scores (k,), ids (k,))
        on the host, what the pump gives for the same submission order.
        Blocks, or raises ``BackpressureError``, when the queue is full."""
        if hybrid is not None and text is None:
            raise ValueError("hybrid submit needs the query text")
        job = Request(-1, query, k, where, hybrid, text, time.perf_counter())
        job.future = Future()
        return self._enqueue(job, timeout)

    def submit_many(self, queries, k: int = 10,
                    timeout: Optional[float] = None) -> List[Future]:
        """``[submit(q, k) for q in queries]`` in one queue operation a
        ``max_queue``-sized chunk: the same order, read-your-writes and
        backpressure accounting. On timeout the futures of the requests
        that did not get in are cancelled and ``BackpressureError``
        raises."""
        if self._closed:
            raise RuntimeError("submit after close")
        t = time.perf_counter()
        jobs = []
        for q in queries:
            job = Request(next(self._rid), q, k, t_enqueue=t)
            job.future = Future()
            jobs.append(job)
        with self._idle:
            self._outstanding += len(jobs)
        step = max(1, self.max_queue)  # a chunk must fit, or it deadlocks
        for i in range(0, len(jobs), step):
            chunk = jobs[i:i + step]
            try:
                depth = self._requests.put_block(
                    chunk, timeout=0 if self.overflow == "reject" else timeout)
            except queue.Full:
                stranded = jobs[i:]
                for job in stranded:
                    job.future.cancel()
                self._resolve_one(len(stranded))
                with self._lock:
                    self.rejected += len(stranded)
                raise BackpressureError(
                    f"request queue full ({self.max_queue}): block stalled "
                    f"at {i}/{len(jobs)}") from None
            if depth > self.queue_depth_max:
                self.queue_depth_max = depth
        return [job.future for job in jobs]

    def submit_write(self, kind: str, vectors=None, ids=None,
                     timeout: Optional[float] = None) -> Future:
        """Thread-safe write (insert, delete, upsert, compact); the Future
        resolves to (kind, the write's result). Reads this thread submits
        afterwards see it; other threads see it once the Future resolves."""
        if kind not in WRITE_KINDS:
            raise ValueError(f"unknown write kind {kind!r}; have {WRITE_KINDS}")
        job = WriteRequest(-1, kind, vectors, ids, time.perf_counter())
        job.future = Future()
        return self._enqueue(job, timeout)

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Block until every accepted job has resolved; True if it did."""
        with self._idle:
            return self._idle.wait_for(lambda: self._outstanding == 0,
                                       timeout)

    def _resolve_one(self, n: int = 1) -> None:
        with self._idle:
            self._outstanding -= n
            if self._outstanding == 0:
                self._idle.notify_all()

    # -------------------------------------------------------------- batcher
    def _apply_write(self, w: WriteRequest) -> None:
        try:
            out = apply_db_write(self.db, w.kind, w.vectors, w.ids)
        except Exception as e:  # the engine's error goes to the caller
            w.future.set_exception(e)
            self._resolve_one()
            return
        w.result = (w.kind, out)
        w.t_done = time.perf_counter()
        with self._lock:
            self.writes_applied += 1
        wal = getattr(self.db, "wal", None)
        if wal is not None and wal.synced_lsn < wal.last_lsn:
            # the record is written but not fsync'd: hold the ack until the
            # flush that makes it durable
            if not self._wal_pending:
                self._wal_deadline = (time.perf_counter()
                                      + max(wal.fsync_interval_ms, 0.0) * 1e-3)
            self._wal_pending.append(w)
            with self._lock:
                self._durable_pending += 1
            return
        w.future.set_result(w.result)
        self._resolve_one()

    def _flush_wal(self) -> None:
        """fsync the log and release every ack held for it (the batcher
        thread only, like every DB access)."""
        if not self._wal_pending:
            return
        self.db.wal.sync()
        held, self._wal_pending = self._wal_pending, []
        with self._lock:
            self._durable_pending -= len(held)
        for w in held:
            w.future.set_result(w.result)
        self._resolve_one(len(held))

    def _get_job(self, timeout: Optional[float]):
        """Pop the next queued job, flushing the group-commit window when
        its deadline passes while the batcher waits (held acks must not
        stall behind an idle queue). Raises queue.Empty only once the
        caller's timeout is spent."""
        deadline = (None if timeout is None
                    else time.perf_counter() + timeout)
        while True:
            t = (None if deadline is None
                 else max(deadline - time.perf_counter(), 0.0))
            if self._wal_pending:
                rem = max(self._wal_deadline - time.perf_counter(), 0.0)
                t = rem if t is None else min(t, rem)
            try:
                return self._requests.get(t)
            except queue.Empty:
                if (self._wal_pending
                        and time.perf_counter() >= self._wal_deadline):
                    self._flush_wal()
                if (deadline is not None
                        and time.perf_counter() >= deadline):
                    raise

    def _copy_to_host(self, scores, ids):
        """Issue the batch's copy to pinned host memory on the batcher's
        stream, after the query's kernels; returns (host tensor, event the
        completer waits on). On the CPU: the results, no event."""
        if not scores.is_cuda:
            return (scores, ids), None
        dev = scores.device
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(device=dev)
        stream = self._copy_stream
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            packed = pack_results(scores, ids)
            host = torch.empty(packed.shape, dtype=packed.dtype,
                               pin_memory=True)
            host.copy_(packed, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(stream)
        # the default stream may reuse these once freed: not before the copy
        scores.record_stream(stream)
        ids.record_stream(stream)
        return host, ready

    def _to_card(self, q):
        """A host batch bound for a DB on the card goes through pinned
        memory without blocking: a copy from pageable memory would wait
        for the previous batch's kernels, and the batcher could not run
        ahead of the card."""
        dev = getattr(self.db, "device", None)
        if (isinstance(q, torch.Tensor) and q.device.type == "cpu"
                and dev is not None and torch.device(dev).type == "cuda"):
            return q.pin_memory().to(dev, non_blocking=True)
        return q

    def _dispatch(self, batch: List[Request]) -> None:
        """Assemble, score and issue the copy of one read micro-batch. The
        caller holds an inflight slot; the completer returns it (or the
        except path here, if the batch never reached the card)."""
        k = max(r.k for r in batch)
        q = assemble_queries(batch, bucket_of(len(batch), self.BUCKETS))
        try:
            qv = self._to_card(self.encoder(q) if self.encoder is not None
                               else q)
            inflight = trace.ON and trace.start("front.inflight",
                                                key=batch[0].rid)
            scores, ids = self.db.query(qv, k=k,
                                        **query_kwargs(batch, len(q)))
            host, ready = self._copy_to_host(scores, ids)
        except Exception as e:
            self._slots.release()
            for r in batch:
                r.future.set_exception(e)
            self._resolve_one(len(batch))
            return
        if inflight:
            _record_queue_waits(batch, inflight)
        self._inflight.put((batch, host, ready, inflight))

    def _batch_loop(self) -> None:
        wait_s = self.max_wait_ms * 1e-3
        pending = self._pending  # batcher-local backlog, bulk-refilled
        done = False
        while not done:
            if pending:
                job = pending.popleft()
            else:
                sp = trace.ON and trace.begin("front.wait")
                job = self._get_job(None)
                if sp:
                    trace.end(sp)
            if job is _SENTINEL:
                break
            if self._discard.is_set():
                job.future.cancel()
                self._resolve_one()
                continue
            if isinstance(job, WriteRequest):
                self._apply_write(job)
                continue
            # take the inflight slot before filling the batch: while the
            # pipeline is full, arrivals ride along in this batch
            sp = trace.ON and trace.begin("front.slot_wait", key=job.rid)
            self._slots.acquire()
            if sp:
                trace.end(sp)
                sp = trace.begin("front.fill", key=job.rid)
            batch = [job]
            group = read_group(job)
            deadline = None  # armed lazily: a saturated queue never sleeps
            closer = None    # the write that closed the batch
            while len(batch) < self.max_batch and not self._discard.is_set():
                if not pending:  # bulk pop: one lock a refill
                    pending.extend(
                        self._requests.pop_ready(self.max_batch - len(batch)))
                if pending:
                    nxt = pending.popleft()
                else:
                    if deadline is None:
                        deadline = time.perf_counter() + wait_s
                    remaining = deadline - time.perf_counter()
                    if remaining <= 0:
                        break
                    try:
                        nxt = self._get_job(remaining)
                    except queue.Empty:
                        break
                if nxt is _SENTINEL:
                    done = True
                    break
                if isinstance(nxt, WriteRequest):
                    closer = nxt  # reads ahead of a write must not see it
                    break
                if read_group(nxt) != group:
                    pending.appendleft(nxt)  # heads the next batch
                    break
                batch.append(nxt)
            if sp:
                trace.end(sp)
                sp = trace.begin("front.dispatch", key=job.rid)
            self._dispatch(batch)
            if sp:
                trace.end(sp)
            if closer is not None:
                if self._discard.is_set():
                    closer.future.cancel()
                    self._resolve_one()
                else:
                    self._apply_write(closer)
        self._sweep_after_sentinel()
        self._flush_wal()  # no ack outlives shutdown without its fsync
        self._inflight.put(_SENTINEL)

    def _sweep_after_sentinel(self) -> None:
        """Serve (or, when discarding, cancel) jobs queued behind the
        shutdown sentinel by a submitter that passed the closed check just
        before ``close()``: accepted work, so no future is orphaned."""
        jobs = list(self._pending)
        self._pending.clear()
        jobs.extend(self._requests.pop_ready(self.max_queue + 1))

        def flush(batch):
            self._slots.acquire()
            self._dispatch(batch)

        batch: List[Request] = []
        for job in jobs:
            if job is _SENTINEL:
                continue
            if self._discard.is_set():
                job.future.cancel()
                self._resolve_one()
            elif isinstance(job, WriteRequest):
                if batch:
                    flush(batch)
                    batch = []
                self._apply_write(job)
            else:
                if batch and read_group(job) != read_group(batch[0]):
                    flush(batch)
                    batch = []
                batch.append(job)
                if len(batch) >= self.max_batch:
                    flush(batch)
                    batch = []
        if batch:
            flush(batch)

    # ------------------------------------------------------------ completer
    def _complete_loop(self) -> None:
        while True:
            item = self._inflight.get()
            if item is _SENTINEL:
                return
            batch, host, ready, inflight = item
            try:
                if ready is not None:
                    ready.synchronize()  # this batch's copy, nothing else
                if inflight:
                    trace.end(inflight)
                # results own plain memory, so that the pinned block goes
                # back to the host allocator's cache for the next batch
                # instead of a fresh pinned allocation
                scores, ids = (host if ready is None
                               else unpack_results(host.clone()))
            except Exception as e:
                self._slots.release()
                for r in batch:
                    r.future.set_exception(e)
                self._resolve_one(len(batch))
                continue
            self._slots.release()  # the results are on the host
            t = time.perf_counter()
            lats = []
            for i, r in enumerate(batch):
                r.result = (scores[i, : r.k], ids[i, : r.k])
                r.t_done = t
                lats.append((t - r.t_enqueue) * 1e3)
            with self._lock:
                self.latencies_ms.extend(lats)
            for r in batch:  # resolve after recording: stats never lag
                r.future.set_result(r.result)
            self._resolve_one(len(batch))

    # ---------------------------------------------------------------- stats
    def latency_stats(self) -> dict:
        """The shared summary (``QueryEngine.latency_stats``) and the
        gauges ``queue_depth`` (now), ``queue_depth_max``, ``rejected``,
        ``inflight`` (batches dispatched, not yet on the host) and
        ``durable_pending`` (write acks held for an fsync).
        Thread-safe; callable while serving."""
        with self._lock:
            lats = list(self.latencies_ms)
            extra = {"queue_depth": self._requests.qsize()
                     + len(self._pending),
                     "queue_depth_max": self.queue_depth_max,
                     "rejected": self.rejected,
                     "inflight": self._inflight.qsize(),
                     "durable_pending": self._durable_pending}
            writes = self.writes_applied
        if not lats and not writes and not self.rejected:
            return {}
        return summarize_latencies(lats, writes, self.db, extra)
