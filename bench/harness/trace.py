"""Spans around the program's entry, and the device trace of a traced run.

``SpanDB`` is the thin forwarding wrapper a traced run hands the serving
front (or calls itself): a span, host start and end, around each
``VectorDB.query``. ``Profile`` runs ``torch.profiler`` over the traced
window, recording the card's activity only (recording every host operation
as well halved the IVF-PQ cell's rate), and reduces it to the busy time of
the device (the union of its kernel, copy and set intervals), the device
time of each kernel name, and the idle gaps labelled by the host span that
was open then: ``db.query``, or one of the harness's own (``result copy``,
``wait for results``). Nothing is written to disk: the trace is summarised
in memory.
"""
from __future__ import annotations

import bisect
import re
import time

import torch

TOP = 10           # entries of each breakdown list
LOOK_BACK = 64     # host spans searched back for the one covering a gap
OUTSIDE = "outside the spans"


class SpanDB:
    """Forwards everything to ``db``; records (host start, host end, rows)
    of each ``query`` call, rows as the caller passed them (padded, when
    the serving front pads)."""

    def __init__(self, db):
        self._db = db
        self.spans = []

    def query(self, q, *args, **kwargs):
        t0 = time.perf_counter()
        out = self._db.query(q, *args, **kwargs)
        self.spans.append((t0, time.perf_counter(), int(q.shape[0])))
        return out

    def __getattr__(self, name):
        return getattr(self._db, name)


def kernel_name(name: str) -> str:
    """A kernel's name without its return type, namespaces, template
    arguments and parameters."""
    name = name.replace("(anonymous namespace)::", "")
    name = re.sub(r"^void\s+", "", name).split("(")[0].split("<")[0]
    return name.split("::")[-1].strip()


class Profile:
    """``torch.profiler`` over the traced window, reduced in memory.
    ``mark`` records a host span of the harness's own."""

    def __init__(self):
        self._prof = None
        self.t0_ns = self.t1_ns = 0
        self.marks = []   # (perf_counter start, end, name)

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        acts = ([ProfilerActivity.CUDA] if torch.cuda.is_available()
                else [ProfilerActivity.CPU])
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self.t0_ns = time.time_ns()

    def stop(self) -> None:
        """Wait for the device, then close the window and the profiler."""
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.t1_ns = time.time_ns()
        self._prof.__exit__(None, None, None)

    def mark(self, name: str, t0: float, t1: float) -> None:
        self.marks.append((t0, t1, name))

    def summary(self, spans=()) -> dict:
        """{busy_s, window_s, device_s (kernel name -> seconds), idle_gaps
        (host span -> seconds)} of the traced window; ``spans`` are the
        (start, end, rows) of ``SpanDB``, on the host's perf_counter."""
        off = time.time_ns() - time.perf_counter_ns()
        host = sorted([(int(a * 1e9) + off, int(b * 1e9) + off, "db.query")
                       for a, b, _ in spans]
                      + [(int(a * 1e9) + off, int(b * 1e9) + off, name)
                         for a, b, name in self.marks])
        w0, w1 = self.t0_ns, self.t1_ns
        dev = []
        for e in self._prof.profiler.kineto_results.events():
            a, b = e.start_ns(), e.start_ns() + e.duration_ns()
            if (b <= w0 or a >= w1 or e.duration_ns() <= 0
                    or str(e.device_type()).endswith("CPU")
                    or e.is_user_annotation()):
                continue
            dev.append((max(a, w0), min(b, w1), kernel_name(e.name())))
        device_s = {}
        for a, b, name in dev:
            device_s[name] = device_s.get(name, 0.0) + (b - a) * 1e-9
        dev.sort()
        busy, gaps, end = 0, [], w0
        for a, b, _ in dev:
            if a > end:
                gaps.append((end, a))
            if b > end:
                busy += b - max(a, end)
                end = b
        if w1 > end:
            gaps.append((end, w1))
        starts = [h[0] for h in host]
        idle = {}
        for a, b in gaps:
            mid = (a + b) // 2
            label = OUTSIDE
            j = bisect.bisect_right(starts, mid) - 1
            for i in range(j, max(-1, j - LOOK_BACK), -1):
                if host[i][1] >= mid:
                    label = host[i][2]
                    break
            idle[label] = idle.get(label, 0.0) + (b - a) * 1e-9
        return {"busy_s": busy * 1e-9, "window_s": (w1 - w0) * 1e-9,
                "device_s": device_s, "idle_gaps": idle}


def top(d: dict) -> list:
    """The TOP largest entries of a {name: seconds} dict, largest first."""
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
