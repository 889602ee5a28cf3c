"""Flat (exact) kNN, the paper's "Iterative" engine (port of
``repro.core.flat``).

The reference's ``flat_search`` is a jnp scan that mirrors the Pallas
``topk_distance`` kernel. Here the query goes through
``kernels.ops.topk_distance`` itself: the CUDA kernel for a corpus on the
card, its plain version on the CPU. This engine is the exact ground truth
that every recall number of the other engines is measured against.
"""
from __future__ import annotations

import torch

from repro_torch.core import distances as D
from repro_torch.core.mutable import GrowableRows, MutationMixin
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops


def flat_search(corpus, q, *, metric: str = "cosine", k: int = 10,
                corpus_sq=None, valid=None):
    """Exact top-k. corpus: (N, d), q: (Q, d) -> (scores (Q,k), ids (Q,k)),
    knocked-out and unfilled slots as (-inf, -1)."""
    k = min(k, corpus.shape[0])
    if metric == "cosine":
        q = D.l2_normalize(q)
        metric = "dot"  # corpus rows were normalized at load time
    s, i = kops.topk_distance(corpus, q, k=k, metric=metric,
                              corpus_sq=corpus_sq, valid=valid)
    return kops.normalize_knockouts(s, i)


class FlatIndex(MutationMixin):
    """Exact-kNN engine (Thistle's Iterative, every metric). The corpus,
    |c|^2 for l2, and a live mask live on ``device``."""

    def __init__(self, metric: str = "cosine", device=None):
        if metric not in D.METRICS:
            raise ValueError(f"metric {metric!r} not in {D.METRICS}")
        self.metric = metric
        self.device = resolve_device(device)
        self.corpus = self.corpus_sq = self.valid = None
        self._corpus = self._sq = self._valid = None
        self._mut_init(0)

    @property
    def size(self) -> int:
        return 0 if self._valid is None else int(self._valid.data.sum())

    def _init_storage(self, corpus, sq, live) -> None:
        self._corpus = GrowableRows.from_array(corpus)
        self._sq = None if sq is None else GrowableRows.from_array(sq)
        self._valid = GrowableRows.from_array(live)
        self._mut_init(corpus.shape[0])
        self._sync()

    def load(self, vectors):
        x = torch.as_tensor(vectors, dtype=torch.float32, device=self.device)
        corpus, sq = D.preprocess_corpus(x, self.metric)
        self._init_storage(corpus, sq, torch.ones(x.shape[0], dtype=torch.bool,
                                                  device=self.device))
        return self

    def _sync(self) -> None:
        if not self._dirty:
            return
        self.corpus = self._corpus.data
        self.corpus_sq = None if self._sq is None else self._sq.data
        self.valid = self._valid.data.clone()
        self.valid[self._valid.n:] = False
        self._dirty = False

    def query(self, q, k: int = 10):
        self._sync()
        q = torch.atleast_2d(torch.as_tensor(q, dtype=torch.float32,
                                             device=self.device))
        return flat_search(self.corpus, q, metric=self.metric, k=k,
                           corpus_sq=self.corpus_sq, valid=self.valid)

    # ------------------------------------------------------- persistence
    def state_dict(self) -> dict:
        n = self.next_id
        state = {"engine": "flat", "metric": self.metric,
                 "corpus": self._corpus.data[:n],
                 "live": self._valid.data[:n],
                 "generation": self.generation}
        if self._sq is not None:
            state["corpus_sq"] = self._sq.data[:n]
        return state

    def load_state(self, state) -> "FlatIndex":
        """Load a state (``state_dict`` or ``core.convert.from_reference_state``):
        corpus rows as stored (already normalized for cosine)."""
        _check_snapshot(state, "flat", self.metric)
        dev = self.device
        sq = state.get("corpus_sq")
        self._init_storage(
            torch.as_tensor(state["corpus"], dtype=torch.float32, device=dev),
            None if sq is None else torch.as_tensor(sq, dtype=torch.float32,
                                                    device=dev),
            torch.as_tensor(state["live"], dtype=torch.bool, device=dev))
        self.generation = int(state.get("generation", 0))
        return self


def _check_snapshot(state, engine: str, metric: str) -> None:
    """Refuse a state saved by another engine or metric: codes and
    corpora are metric-specific, and restoring across would rank wrong."""
    got_engine = str(state.get("engine", engine))
    got_metric = str(state.get("metric", metric))
    if got_engine != engine or got_metric != metric:
        raise ValueError(
            f"state was saved by engine={got_engine!r} metric={got_metric!r},"
            f" cannot load into engine={engine!r} metric={metric!r}")
