"""Online autotuner for the IVF-ADC grid dispatch (port of
``repro.kernels.autotune``; pure Python, a copy of the reference's).

``ops.ivf_adc_topk(mode="auto")`` asks the process-wide :data:`LEDGER`
for a decision keyed by ``(backend, m, ksub, blk, lut_dtype)``, where
backend is ``"cuda"`` (the kernels) or ``"plain"`` (their plain versions).
Until the key has one, each auto batch runs ONE candidate grid (per_query,
blocked at the default group width, run-resident over a small qblk sweep)
with a warm-up call and then a timed call, each ending in a device
synchronize, and records (sharing factor, wall seconds). The timed call is
the dispatch as the batch is served: for a grouped grid, the schedule from
the cache or, on a miss, built with the kernel's pair index. Every candidate
returns the same results bit for bit, so probe batches serve real answers
while they measure.

Once every candidate has ``reps`` timings the tuner fits the decision:

* ``grouped_mode``/``qblk``: the fastest grouped candidate by min-of-reps.
* ``crossover``: the sharing factor above which the grouped grid
  dispatches. The probe batches of one key cluster around one sharing
  value s, so the fit is one-sided: grouped won at s =>
  ``crossover = max(1.0, s / 2)``; per_query won at s =>
  ``crossover = 2 * s``.

Steady state is then one dict lookup per batch: grouped iff the batch's
cheap sharing probe clears ``crossover`` (and the scatter board fits the
reference's bound). ``decisions()`` exports the ledger for telemetry.
"""
from __future__ import annotations

from typing import Optional

PROBE_REPS = 2
QBLK_CANDIDATES = (4, 8, 16)
BLOCKED_PROBE_QBLK = 8  # the blocked grid probes at the default group width


class AutoTuner:
    """Measured-probe ledger for the ADC grid dispatch (see module doc).

    One instance is process-wide (:data:`LEDGER`); tests build private
    instances and pass them through ``ivf_adc_topk(autotune=...)``.
    """

    def __init__(self, reps: int = PROBE_REPS, qblks=QBLK_CANDIDATES):
        assert reps >= 1, reps
        self.reps = int(reps)
        self.candidates = ([("per_query", 0), ("blocked", BLOCKED_PROBE_QBLK)]
                           + [("run_resident", int(qb)) for qb in qblks])
        self._entries: dict = {}

    # ------------------------------------------------------------- probe
    def _entry(self, key):
        e = self._entries.get(key)
        if e is None:
            e = {"times": {c: [] for c in self.candidates}, "sharing": [],
                 "decision": None}
            self._entries[key] = e
        return e

    def next_probe(self, key) -> Optional[tuple]:
        """The next (mode, qblk) candidate still owed a timing for ``key``,
        or None when the key is fully measured (use :meth:`lookup`)."""
        e = self._entry(key)
        if e["decision"] is not None:
            return None
        for cand in self.candidates:
            if len(e["times"][cand]) < self.reps:
                return cand
        return None

    def record(self, key, candidate, sharing: float, seconds: float) -> None:
        """File one measured probe; fits the decision once every candidate
        has ``reps`` timings."""
        e = self._entry(key)
        e["times"][candidate].append(float(seconds))
        e["sharing"].append(float(sharing))
        if all(len(ts) >= self.reps for ts in e["times"].values()):
            e["decision"] = self._fit(e)

    def _fit(self, e) -> dict:
        best = {c: min(ts) for c, ts in e["times"].items()}
        t_pq = best[("per_query", 0)]
        grouped = [(t, c) for c, t in best.items() if c[0] != "per_query"]
        t_grp, (gmode, gqblk) = min(grouped)
        sharings = sorted(e["sharing"])
        s_med = sharings[len(sharings) // 2]
        # one-sided crossover fit (probe sharings cluster at one point);
        # straddling measurements refine it to a geometric mean
        lo = s_med if t_pq <= t_grp else None   # per_query won here
        hi = s_med if t_grp < t_pq else None    # grouped won here
        if lo is not None and hi is not None and lo < hi:
            crossover = (lo * hi) ** 0.5
        elif hi is not None:
            crossover = max(1.0, hi / 2.0)
        else:
            crossover = 2.0 * lo
        return {"grouped_mode": gmode, "qblk": int(gqblk),
                "crossover": float(crossover),
                "t_per_query": float(t_pq), "t_grouped": float(t_grp),
                "sharing": float(s_med),
                "probes": sum(len(ts) for ts in e["times"].values())}

    # ---------------------------------------------------------- steady state
    def lookup(self, key) -> Optional[dict]:
        """The fitted decision for ``key``, or None while still probing."""
        e = self._entries.get(key)
        return None if e is None else e["decision"]

    def seed(self, key, decision: dict) -> None:
        """Install a decision without probing (tests, warm-started serving)."""
        e = self._entry(key)
        e["decision"] = dict(decision)

    def decisions(self) -> dict:
        """``{key_str: decision}`` for every fitted key — the telemetry /
        CI-artifact export."""
        return {" ".join(map(str, k)): dict(e["decision"])
                for k, e in self._entries.items()
                if e["decision"] is not None}

    def reset(self) -> None:
        self._entries.clear()


LEDGER = AutoTuner()
