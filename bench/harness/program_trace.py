"""The program's own spans and counters (``repro_torch.trace``) on the
device trace's clock.

``ProgramProfile`` is ``trace.Profile`` with the program's recorder on over
the profiled window. It takes one offset between ``time.perf_counter_ns``
(the recorder's clock) and the profiler's clock as the window opens and a
second as it closes (their difference is ``clock_drift_ns``), and reduces
the window to:

* ``idle_gaps``: each idle gap of the card under the innermost program span
  open at its midpoint on the thread that calls ``db.query``, else under
  the harness's own spans (``SpanDB``'s ``db.query``, the marks), else
  under ``outside the spans``; each thread's spans are searched as nested
  intervals (``Intervals``), so per-request spans cannot hide the one that
  covers a gap;
* ``host_s``: the window of that thread under the same labels;
* ``device_by_span``: each kernel's device time under the program span open
  where the host launched it, matched through the profiler's correlation
  between a kernel and its CUDA runtime call;
* ``program``: the per-layer numbers the program's spans and counters give
  (``program_numbers``).

Nothing is written to disk. ``repro_torch`` is imported as the window
opens, not with this module, as ``harness.trace`` imports nothing of the
program.
"""
from __future__ import annotations

import bisect
import sys

from harness.trace import OUTSIDE, Profile, kernel_name

STAGES = ("ivf.probe", "ivf.dispatch", "ivf.rerank")
HOST_STEP_NS = 20_000   # the sampling step of ``host_s``


class Intervals:
    """The innermost of one thread's nested intervals ``(start, end,
    label)`` that is open at a time: the last interval to start at or
    before it, or, if that one has ended, the nearest interval around it
    that has not (any interval open then started before that one and
    encloses it)."""

    def __init__(self, items):
        self.items = sorted(items, key=lambda x: (x[0], -x[1]))
        self.starts = [a for a, _, _ in self.items]
        self.outer, stack = [], []
        for i, (a, b, _) in enumerate(self.items):
            while stack and self.items[stack[-1]][1] < a:
                stack.pop()
            self.outer.append(stack[-1] if stack else -1)
            stack.append(i)

    def at(self, t: int):
        """The label of the innermost interval open at ``t``, or None."""
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and self.items[i][1] < t:
            i = self.outer[i]
        return None if i < 0 else self.items[i][2]


def _on_profiler_clock(drained: dict, off: int) -> list:
    """The recorder's spans with both ends moved onto the profiler's clock
    (an end of 0, never reached, stays 0)."""
    return [(name, a + off, b + off if b else 0, tid, parent, key)
            for name, a, b, tid, parent, key in drained["spans"]]


def program_threads(spans) -> dict:
    """{thread: Intervals of its spans} for each thread that ran
    ``db.query``; a span still open at the drain is open to the end."""
    tids = {s[3] for s in spans if s[0] == "db.query"}
    return {t: Intervals([(a, b or sys.maxsize, name)
                          for name, a, b, tid, _, _ in spans if tid == t])
            for t in tids}


def program_numbers(drained: dict, off: int, w0: int, w1: int,
                    device_s: dict) -> dict:
    """{metric name: value} of the window ``[w0, w1]`` (profiler clock):

    * ``db.host_syncs``: the counter ``host_syncs`` (its change over the
      window, in ``drained``) over the window's ``db.query`` calls;
    * ``engine.{probe,dispatch,rerank}_host_ms``: the mean duration of the
      stage's span;
    * ``engine.{probe,rerank}_device_ms``: device time of the kernels
      launched inside the stage's spans (``device_s``, seconds by span
      name; absent when no launch was matched) over the stage's calls;
    * ``front.queue_wait_ms``: the mean ``front.queue`` of the requests
      whose batch started in the window; ``front.inflight_ms``: the mean,
      over the same requests, of their batch's ``front.inflight``.

    A number whose spans did not occur is left out."""
    spans = _on_profiler_clock(drained, off)
    inside = [s for s in spans if w0 <= s[1] and 0 < s[2] <= w1]
    out = {}
    calls = sum(s[0] == "db.query" for s in inside)
    if calls:
        out["db.host_syncs"] = (drained["counters"].get("host_syncs", 0)
                                / calls)
    for stage in STAGES:
        d = [b - a for name, a, b, _, _, _ in inside if name == stage]
        if not d:
            continue
        short = stage.split(".")[1]
        out[f"engine.{short}_host_ms"] = 1e-6 * sum(d) / len(d)
        if short in ("probe", "rerank") and stage in device_s:
            out[f"engine.{short}_device_ms"] = 1e3 * device_s[stage] / len(d)
    queue = [s for s in spans if s[0] == "front.queue" and w0 <= s[2] <= w1]
    if queue:
        out["front.queue_wait_ms"] = 1e-6 * sum(b - a for _, a, b, _, _, _
                                                in queue) / len(queue)
        batch = [spans[s[4]] for s in queue if s[4] >= 0]
        batch = [b - a for _, a, b, _, _, _ in batch if b]
        if batch:
            out["front.inflight_ms"] = 1e-6 * sum(batch) / len(batch)
    return out


def device_events(prof, w0: int, w1: int):
    """(kernels [(start, end, name, correlation)] clipped to the window,
    launches {correlation: host start}) of a ``torch.profiler`` run: the
    device's activity, and the CUDA runtime calls on the host that started
    it. The runtime calls' thread ids are not the operating system's (an
    H100 run matched none), so a launch is placed by its time alone, on
    the threads that call ``db.query``, which launch every kernel of a
    query."""
    kernels, launches = [], {}
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation():
            continue
        if str(e.device_type()).endswith("CPU"):
            if e.correlation_id():
                launches[e.correlation_id()] = e.start_ns()
            continue
        a, b = e.start_ns(), e.start_ns() + e.duration_ns()
        if b <= w0 or a >= w1 or e.duration_ns() <= 0:
            continue
        kernels.append((max(a, w0), min(b, w1), kernel_name(e.name()),
                        e.correlation_id() or e.linked_correlation_id()))
    return kernels, launches


class ProgramProfile(Profile):
    """``trace.Profile`` with the program's recorder on over the profiled
    window; ``summary`` adds what the program recorded. ``arm()``, called
    before the traffic ahead of the window ends, turns the recorder on
    earlier, so that a wait a thread is in as the window opens (the async
    front's batcher waiting for its first request) is on record too.
    Either way the counters are read as their change over the window."""

    def __init__(self):
        super().__init__()
        self.off0 = self.off1 = 0
        self.counters0 = {}
        self.drained = {"spans": [], "counters": {}, "dropped": 0}

    def arm(self) -> None:
        from repro_torch import trace as recorder
        if not recorder.ON:
            recorder.enable()

    def start(self) -> None:
        from repro_torch import trace as recorder
        super().start()
        self.off0 = recorder.profiler_clock_offset()
        self.arm()
        self.counters0 = recorder.counters()

    def stop(self) -> None:
        from repro_torch import trace as recorder
        recorder.disable()
        super().stop()
        self.off1 = recorder.profiler_clock_offset()
        self.drained = recorder.drain()
        self.drained["counters"] = {
            k: v - self.counters0.get(k, 0)
            for k, v in self.drained["counters"].items()}
        print(f"program trace: {len(self.drained['spans'])} spans, "
              f"{self.drained['dropped']} dropped, clock drift "
              f"{self.off1 - self.off0} ns over the window", file=sys.stderr)

    def summary(self, spans=()) -> dict:
        """``Profile.summary``'s busy and device time, with ``idle_gaps``
        labelled by the program's spans first; adds ``host_s`` (the
        window of the thread that calls ``db.query`` under the same labels,
        sampled every ``HOST_STEP_NS``), ``device_by_span`` (span name ->
        seconds), ``program`` (``program_numbers``),
        ``clock_drift_ns``, ``dropped`` and ``launches_matched`` (the
        share of the window's kernels whose host launch was found)."""
        out = super().summary(spans)
        w0, w1 = self.t0_ns, self.t1_ns
        off = self.off0
        kernels, launches = device_events(self._prof, w0, w1)
        prog = _on_profiler_clock(self.drained, off)
        threads = program_threads(prog)
        harness = Intervals(
            [(int(a * 1e9) + off, int(b * 1e9) + off, "db.query")
             for a, b, _ in spans]
            + [(int(a * 1e9) + off, int(b * 1e9) + off, name)
               for a, b, name in self.marks])

        def label(t):
            for iv in threads.values():
                found = iv.at(t)
                if found is not None:
                    return found
            return None

        device_by_span, matched = {}, 0
        for a, b, _, corr in kernels:
            t = launches.get(corr)
            if t is None:
                continue
            matched += 1
            name = label(t)
            if name is not None:
                device_by_span[name] = (device_by_span.get(name, 0.0)
                                        + (b - a) * 1e-9)
        dev = sorted((a, b) for a, b, _, _ in kernels)
        idle, end = {}, w0
        for a, b in dev + [(w1, w1)]:
            if a > end:
                mid = (a + end) // 2
                name = label(mid) or harness.at(mid) or OUTSIDE
                idle[name] = idle.get(name, 0.0) + (a - end) * 1e-9
            end = max(end, b)
        out["idle_gaps"] = idle
        host = {}
        for t in range(w0, w1, HOST_STEP_NS):
            name = label(t) or harness.at(t) or OUTSIDE
            host[name] = host.get(name, 0.0) + HOST_STEP_NS * 1e-9
        out["host_s"] = host
        out["device_by_span"] = device_by_span
        out["program"] = program_numbers(self.drained, off, w0, w1,
                                         device_by_span)
        out["clock_drift_ns"] = self.off1 - self.off0
        out["dropped"] = self.drained["dropped"]
        out["launches_matched"] = matched / len(kernels) if kernels else None
        return out
