"""The ``blocks`` driver: one caller on ``db.query``, a closed loop of
``block`` queries a call taken in order from the pool (cycled), ``depth``
calls dispatched before the oldest one's results are read on the host.
Latency and the window's counts as ``harness.record`` defines them."""
from __future__ import annotations

import collections
import time
import traceback

import numpy as np

from harness.record import Record, to_host, unpack

KEEP_PER_BLOCK = 4   # answers of a block kept as candidates for the sample


class Driver:
    def __init__(self, traffic: dict, pool, seed: int):
        self.block = int(traffic["block"])
        self.depth = int(traffic["depth"])
        self.k = int(traffic["k"])
        self.warm_blocks = int(traffic["warmup_blocks"])
        self.pool = pool
        self.P = pool.shape[0]
        if self.P % self.block:
            raise ValueError(f"pool {self.P} is no multiple of the block "
                             f"{self.block}")
        self.rng = np.random.default_rng(seed)
        self.next_block = 0

    def _loop(self, db, rec, t_end, max_calls=None, profile=None):
        inflight = collections.deque()
        calls = 0
        while True:
            now = time.perf_counter()
            going = now < t_end and (max_calls is None or calls < max_calls)
            if going:
                # a block is a slice of the pool on the device: no copy
                # from the host orders the call behind the card's queue
                a = (self.next_block * self.block) % self.P
                self.next_block += 1
                calls += 1
                t0 = time.perf_counter()
                try:
                    s, i = db.query(self.pool[a:a + self.block], k=self.k)
                    t_q = time.perf_counter()
                    host, ev = to_host(s, i)
                    if profile is not None:
                        profile.mark("result copy", t_q, time.perf_counter())
                except Exception:
                    traceback.print_exc()
                    host = ev = None
                inflight.append((a, t0, host, ev))
                rec.attempted += self.block
                rec.calls.append(a)
            elif profile is not None:
                profile.stop()
                profile = None
            if inflight and (len(inflight) >= self.depth or not going):
                a, t0, host, ev = inflight.popleft()
                t_w = time.perf_counter()
                if ev is not None:
                    ev.synchronize()
                t1 = time.perf_counter()
                if profile is not None:
                    profile.mark("wait for results", t_w, t1)
                if host is None:
                    rec.failed += self.block
                    continue
                rec.latencies_ms.append(((t1 - t0) * 1e3, self.block, t1))
                if t1 <= t_end:
                    rec.completed_in_window += self.block
                s, i = unpack(host)
                for r in self.rng.choice(self.block, KEEP_PER_BLOCK,
                                         replace=False):
                    rec.kept.append((a + int(r), s[r].copy(), i[r].copy()))
            elif not going:
                return

    def warm(self, db) -> None:
        """``warmup_blocks`` calls through the same loop, before the
        window: the autotuner's probes and every launch plan of the
        window's shapes happen here."""
        self._loop(db, Record(), float("inf"), max_calls=self.warm_blocks)

    def window(self, db, seconds: float, profile=None) -> Record:
        if profile is not None:
            profile.start()
        rec = Record(t_start=time.perf_counter())
        rec.t_end = rec.t_start + seconds
        self._loop(db, rec, rec.t_end, profile=profile)
        return rec

    def close(self) -> None:
        pass
