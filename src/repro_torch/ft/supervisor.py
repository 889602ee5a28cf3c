"""Fault-tolerant training supervisor: checkpoint/restart, elastic re-mesh,
straggler mitigation (port of ``repro.ft.supervisor``; pure Python).

  * ``Supervisor.run`` drives a ``TrainJob``; a ``NodeFailure`` in a step
    rolls back to the last checkpoint and replays (the data path is a
    function of the step, so the replay is exact).
  * ``elastic_after`` consecutive failures rebuild the job on a smaller
    device set (``TrainJob.remesh``).
  * ``StragglerMonitor`` tracks per-host step latencies; a host slower
    than ``deadline_factor`` x the median has its data shard skipped for
    that step, and a persistent straggler is reported for the elastic path.

Failures are injected (``ft.faults.FailureInjector`` raises at configured
steps), which runs exactly the code path a preemption signal would.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.checkpoint import CheckpointStore
from repro_torch.ft.faults import FailureInjector, NodeFailure  # noqa: F401


@dataclasses.dataclass
class StragglerMonitor:
    n_hosts: int
    deadline_factor: float = 3.0
    history: int = 20
    persistent_limit: int = 5

    def __post_init__(self):
        self._lat: List[List[float]] = [[] for _ in range(self.n_hosts)]
        self._strikes = np.zeros(self.n_hosts, np.int64)

    def observe(self, host_latencies: Sequence[float]) -> List[int]:
        """Returns host ids whose data shard should be skipped this step."""
        med = float(np.median(host_latencies))
        skip = []
        for h, lat in enumerate(host_latencies):
            self._lat[h] = (self._lat[h] + [lat])[-self.history:]
            if lat > self.deadline_factor * max(med, 1e-9):
                self._strikes[h] += 1
                skip.append(h)
            else:
                self._strikes[h] = 0
        return skip

    def persistent_stragglers(self) -> List[int]:
        return [h for h in range(self.n_hosts)
                if self._strikes[h] >= self.persistent_limit]


class TrainJob:
    """What the supervisor runs.

      run_step(step) -> metrics  one optimizer step (may raise NodeFailure)
      save_state(store, step) / load_state(store) -> step or None
      remesh(scale) -> TrainJob  rebuilt on a reduced device set
    """

    def run_step(self, step: int) -> Dict:  # pragma: no cover - interface
        raise NotImplementedError

    def save_state(self, store: CheckpointStore, step: int):
        raise NotImplementedError

    def load_state(self, store: CheckpointStore) -> Optional[int]:
        raise NotImplementedError

    def remesh(self, scale: float) -> "TrainJob":
        raise NotImplementedError


@dataclasses.dataclass
class Supervisor:
    job: TrainJob
    store: CheckpointStore
    total_steps: int
    checkpoint_every: int = 50
    max_retries: int = 10
    elastic_after: int = 2  # consecutive failures before shrinking the mesh
    on_event: Optional[Callable[[str, dict], None]] = None

    def _emit(self, kind: str, **info):
        if self.on_event:
            self.on_event(kind, info)

    def run(self) -> Dict:
        step = 0
        start = self.job.load_state(self.store)
        if start is not None:
            step = start
            self._emit("resume", step=step)
        consecutive_failures = 0
        retries = 0
        history = []
        while step < self.total_steps:
            try:
                metrics = self.job.run_step(step)
                history.append(metrics)
                step += 1
                consecutive_failures = 0
                if step % self.checkpoint_every == 0 or step == self.total_steps:
                    self.job.save_state(self.store, step)
                    self._emit("checkpoint", step=step)
            except NodeFailure as e:
                retries += 1
                consecutive_failures += 1
                self._emit("failure", step=step, error=str(e),
                           consecutive=consecutive_failures)
                if retries > self.max_retries:
                    raise RuntimeError(f"exceeded {self.max_retries} retries") from e
                if consecutive_failures >= self.elastic_after:
                    self._emit("elastic_remesh", step=step)
                    self.job = self.job.remesh(0.5)
                    consecutive_failures = 0
                restored = self.job.load_state(self.store)
                step = restored if restored is not None else 0
                self._emit("restart", step=step)
        return {"final_step": step, "n_retries": retries, "history": history}
