"""The ``clients`` driver: ``clients`` threads, each a closed loop of one
query through ``AsyncQueryEngine.submit`` (the front's settings under
``front``), client c sending pool rows c, c + clients, ... Latency and the
window's counts as ``harness.record`` defines them."""
from __future__ import annotations

import threading
import time
import traceback

from harness.record import Record


class Driver:
    def __init__(self, traffic: dict, pool, seed: int):
        self.n = int(traffic["clients"])
        self.k = int(traffic["k"])
        self.front = dict(traffic["front"])
        self.warm_s = float(traffic["warmup_s"])
        self.host_pool = pool.cpu()
        self.P = pool.shape[0]
        self.engine = None

    def _run(self, seconds: float, profile=None) -> tuple:
        """The client threads for ``seconds``; (start, end, answers)."""
        outs = [[] for _ in range(self.n)]
        start = threading.Barrier(self.n + 1)
        t_end = [0.0]   # set before the barrier opens, read after it
        threads = [threading.Thread(target=self._client,
                                    args=(c, t_end, outs[c], start),
                                    name=f"bench-client-{c}")
                   for c in range(self.n)]
        for t in threads:
            t.start()
        if profile is not None:
            profile.start()
        t0 = time.perf_counter()
        t_end[0] = t0 + seconds
        start.wait()
        if profile is not None:
            time.sleep(max(0.0, t_end[0] - time.perf_counter()))
            profile.stop()
        for t in threads:
            t.join()
        return t0, t_end[0], [a for out in outs for a in out]

    def _client(self, c: int, t_end: list, out: list, start) -> None:
        """Client c's closed loop. The latency ends when the front's
        completer resolves the future (the result is on the host then),
        not when this thread next runs."""
        start.wait()
        j = c
        while time.perf_counter() < t_end[0]:
            row = j % self.P
            j += self.n
            done, stamped = [], threading.Event()

            def stamp(_fut, done=done, stamped=stamped):
                done.append(time.perf_counter())
                stamped.set()

            t0 = time.perf_counter()
            try:
                fut = self.engine.submit(self.host_pool[row], k=self.k)
                fut.add_done_callback(stamp)
                s, i = fut.result()
                stamped.wait()  # callbacks run just after waiters wake
                out.append((row, t0, done[0], s.numpy().copy(),
                            i.numpy().copy()))
            except Exception:
                traceback.print_exc()
                out.append((row, t0, None, None, None))

    def warm(self, db) -> None:
        """Every plan bucket the front can form, once on ``db.query``; then
        the clients through the front for ``warmup_s``."""
        from repro_torch.serve.async_engine import AsyncQueryEngine
        dev = getattr(db, "device", None)
        q = self.host_pool[:self.front["max_batch"]]
        b = 1
        while b <= self.front["max_batch"]:
            db.query(q[:b].to(dev), k=self.k)
            b *= 2
        self.engine = AsyncQueryEngine(db, **self.front)
        self._run(self.warm_s)

    def window(self, db, seconds: float, profile=None) -> Record:
        """The window, through the front that ``warm`` started on ``db``."""
        t0, t_end, out = self._run(seconds, profile)
        rec = Record(t_start=t0, t_end=t_end)
        for row, a, b, s, i in out:
            rec.attempted += 1
            if b is None:
                rec.failed += 1
                rec.kept.append((row, None, None))
                continue
            rec.latencies_ms.append(((b - a) * 1e3, 1, b))
            rec.completed_in_window += b <= t_end
            rec.kept.append((row, s, i))
        return rec

    def close(self) -> None:
        if self.engine is not None:
            self.engine.close()
            self.engine = None
