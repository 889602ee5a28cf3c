"""VectorDB: Thistle's load/query trait as the deployment API (port of
``repro.core.db``, the single-host load and query path).

    db = VectorDB(engine="flat|ivf_pq", metric="cosine|l2|dot")
    db.load(vectors)
    scores, ids = db.query(q, k=10)

The front canonicalizes each batch to the ``PLAN_BUCKETS`` ladder and
counts plan hits and misses as the reference does, so that the serving
layer reads the same counters; padded rows repeat the last query and are
sliced off again. Entry points run on the GPU unless given
``device="cpu"``.
"""
from __future__ import annotations

from typing import Dict, Type

import torch

from repro_torch.core import distances as D
from repro_torch.core.flat import FlatIndex
from repro_torch.core.pq import IVFPQIndex
from repro_torch.device import resolve_device

ENGINES: Dict[str, Type] = {
    "flat": FlatIndex,      # paper: Iterative (exact); the recall oracle
    "ivf_pq": IVFPQIndex,   # IVF buckets of PQ residuals + exact re-rank
}

# plan bucket ladder: batches pad up to the next bucket
PLAN_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512)


class _PlanLedger:
    """Plan bookkeeping: canonicalize the batch to the PLAN_BUCKETS ladder,
    count hit/miss per (engine, bucket, k, dtype, generation) plan key, pad
    the batch up to its bucket."""

    def _plan_init(self):
        self.plan_buckets = PLAN_BUCKETS
        self.plan_generation = 0
        self._plans = set()
        self.plan_stats = {"hits": 0, "misses": 0}

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


class VectorDB(_PlanLedger):
    """Single-host front end over the engine registry. Single-writer,
    single-reader: callers serialize access."""

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
        self._plan_init()

    def _plan_salt(self) -> tuple:
        # the ADC grid mode changes the search program on the same shapes
        return (getattr(self.index, "adc_mode", None),)

    def load(self, vectors) -> "VectorDB":
        vectors = torch.as_tensor(vectors, device=self.device)
        if vectors.dim() != 2:
            raise ValueError(f"load takes (N, d) vectors, got {tuple(vectors.shape)}")
        self.index.load(vectors)
        self.n = vectors.shape[0]
        self._loaded = True
        return self

    def load_state(self, state) -> "VectorDB":
        """Serve a saved engine state: the engine's own ``state_dict`` or a
        reference state through ``core.convert.from_reference_state``."""
        self.index.load_state(state)
        self.n = self.index.size
        self._loaded = True
        return self

    def query(self, q, k: int = 10, *, bucketize: bool = True, where=None,
              hybrid=None):
        """q: (d,) or (Q, d) -> (scores (Q, k) f32, ids (Q, k) int32).

        ``bucketize`` pads Q up to the plan-bucket ladder; rows are
        independent in every engine, so the padded rows (repeats of the
        last query) cannot change the first Q results.
        """
        if where is not None or hybrid is not None:
            raise NotImplementedError(
                "filtered and hybrid search come with ROADMAP.md Queue 1, "
                "item 7")
        if not self._loaded:
            raise RuntimeError("query before load")
        q = torch.atleast_2d(torch.as_tensor(q, dtype=torch.float32,
                                             device=self.device))
        kk = min(k, self.n)
        if kk <= 0:
            return _empty_result(q.shape[0], k, self.device)
        if bucketize:
            q, Q = self._plan_batch(q, kk)
        else:
            Q = q.shape[0]
        scores, ids = self.index.query(q, k=kk)
        return scores[:Q], ids[:Q]
