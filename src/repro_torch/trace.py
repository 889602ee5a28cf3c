"""An in-memory recorder of spans and counters on the query path.

Off by default. ``enable()`` turns it on and ``disable()`` off; nothing
else does. While it is off, a span site costs one test of the module flag
``ON``::

    sp = trace.ON and trace.begin("ivf.probe")
    ...
    if sp:
        trace.end(sp)

and records nothing. While it is on, each span is a row ``(name, start_ns,
end_ns, thread, parent, key)`` of a buffer allocated by ``enable`` with a
fixed cap: times are ``time.perf_counter_ns()``, ``thread`` is the
operating system's id of the thread that opened the span
(``threading.get_native_id()``), 0 for a wait handed from one thread to
another (``start``), ``parent`` is the row of the span that was open on
that thread when it began (-1 for none), ``key`` the request or batch id
the site passes (-1 for none). Spans past the cap are dropped and counted.
Counters are integers by name (``count``).

``drain()`` hands out what was recorded and empties the buffer; nothing is
written to disk. Call it once the traffic it should cover has stopped: a
span still open then keeps ``end_ns`` 0, and its end is not recorded.
``profiler_clock_offset()`` moves a time onto ``torch.profiler``'s clock.

The query path's spans and counter (README.md's port section tables
them):
``db.query`` (all of ``VectorDB.query``), ``ivf.probe``, ``ivf.dispatch``
and ``ivf.rerank`` (the stages of ``core.pq.ivf_pq_search``), the counter
``host_syncs`` (each read of a device value on the host on the query
path), and the async front's ``front.wait`` (for a first request),
``front.slot_wait``, ``front.fill``, ``front.dispatch`` (batcher thread),
``front.inflight`` (a batch, from its ``db.query`` to its results on the
host) and ``front.queue`` (a request, from ``submit`` to its batch's
``db.query``; its parent is the batch's ``front.inflight``).
"""
from __future__ import annotations

import itertools
import threading
import time

ON = False          # the flag every span and counter site tests
DEFAULT_CAP = 1 << 18   # spans a buffer holds

_cap = 0
_gen = 0            # bumped by enable and drain: a stale token is ignored
_next = itertools.count()
_name: list = []
_t0: list = []
_t1: list = []
_tid: list = []
_parent: list = []
_key: list = []
_counters: dict = {}
_count_lock = threading.Lock()
_local = threading.local()

_GEN_SHIFT = 40     # a token is (generation << _GEN_SHIFT) | (row + 1)
_ROW_MASK = (1 << _GEN_SHIFT) - 1


def enable() -> None:
    """Start recording into an empty buffer of ``DEFAULT_CAP`` spans."""
    global ON, _cap
    _cap = DEFAULT_CAP
    _reset()
    ON = True


def disable() -> None:
    """Stop recording; what was recorded stays until ``drain``."""
    global ON
    ON = False


def _reset() -> None:
    global _gen, _next, _name, _t0, _t1, _tid, _parent, _key, _counters
    _gen += 1
    _next = itertools.count()
    _name, _t0, _t1 = [None] * _cap, [0] * _cap, [0] * _cap
    _tid, _parent, _key = [0] * _cap, [-1] * _cap, [-1] * _cap
    _counters = {}


def _stack() -> list:
    """This thread's open spans (rows) of the current buffer. The thread's
    id is read once here: ``threading.get_native_id`` is a system call,
    which costs 11 us on some hosts."""
    if getattr(_local, "gen", None) != _gen:
        _local.gen, _local.stack = _gen, []
        _local.tid = threading.get_native_id()
    return _local.stack


def _row(name: str, t0: int, tid: int, parent: int, key: int) -> int:
    """Claim the next row (``next`` on the counter is atomic under the
    interpreter lock); -1 past the cap."""
    i = next(_next)
    if i >= _cap:
        return -1
    _name[i], _t0[i], _tid[i], _parent[i], _key[i] = name, t0, tid, parent, key
    return i


def _token(i: int) -> int:
    return -1 if i < 0 else (_gen << _GEN_SHIFT) | (i + 1)


def begin(name: str, key: int = -1) -> int:
    """Open a span on this thread, nested in the one open here: a token
    for ``end`` (never 0, so ``ON and begin(...)`` is false only when
    off)."""
    st = _stack()
    i = _row(name, time.perf_counter_ns(), _local.tid, st[-1] if st else -1,
             key)
    if i >= 0:
        st.append(i)
    return _token(i)


def start(name: str, key: int = -1) -> int:
    """Open a span that another thread may end (thread 0, no parent, not
    nested): a token for ``end``."""
    return _token(_row(name, time.perf_counter_ns(), 0, -1, key))


def end(token: int) -> None:
    """Close the span of ``token`` now; a span this thread opened with
    ``begin`` leaves its stack, with any child left open by an exception.
    A token of a dropped span or of an earlier buffer is ignored."""
    if token < 0 or token >> _GEN_SHIFT != _gen:
        return
    i = (token & _ROW_MASK) - 1
    _t1[i] = time.perf_counter_ns()
    st = _stack()
    if i in st:
        del st[st.index(i):]


def span_start(token: int) -> int:
    """The start (ns) of the span of ``token``; 0 for a dropped span or one
    of an earlier buffer."""
    if token < 0 or token >> _GEN_SHIFT != _gen:
        return 0
    return _t0[(token & _ROW_MASK) - 1]


def record(name: str, t0_ns: int, t1_ns: int, *, parent: int = 0,
           key: int = -1) -> int:
    """A whole span of thread 0 whose ends are known (a request's wait,
    stamped when it was handed over); ``parent`` is a token or 0 for none.
    Returns its token."""
    p = -1
    if parent > 0 and parent >> _GEN_SHIFT == _gen:
        p = (parent & _ROW_MASK) - 1
    i = _row(name, t0_ns, 0, p, key)
    if i >= 0:
        _t1[i] = t1_ns
    return _token(i)


def profiler_clock_offset() -> int:
    """Nanoseconds to add to a span's time to put it on the profiler's
    clock (the Unix clock), read between two readings of
    ``perf_counter_ns``."""
    a = time.perf_counter_ns()
    w = time.time_ns()
    b = time.perf_counter_ns()
    return w - (a + b) // 2


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    with _count_lock:
        _counters[name] = _counters.get(name, 0) + n


def counters() -> dict:
    """A copy of the counters as they stand."""
    with _count_lock:
        return dict(_counters)


def drain() -> dict:
    """{"spans": [(name, start_ns, end_ns, thread, parent, key), ...] in
    the order they began (``parent`` indexes this list), "counters":
    {name: int}, "dropped": spans past the cap}; then empties the buffer."""
    issued = next(_next)
    n = min(issued, _cap)
    spans = list(zip(_name[:n], _t0[:n], _t1[:n], _tid[:n], _parent[:n],
                     _key[:n]))
    out = {"spans": spans, "counters": dict(_counters),
           "dropped": max(0, issued - _cap)}
    _reset()
    return out
