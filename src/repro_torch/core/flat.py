"""Flat (exact) kNN, the paper's "Iterative" engine (port of
``repro.core.flat``).

The reference's ``flat_search`` is a jnp scan that mirrors the Pallas
``topk_distance`` kernel. Here the query goes through
``kernels.ops.topk_distance`` itself: the CUDA kernel for a corpus on the
card, its plain version on the CPU. This engine is the exact ground truth
that every recall number of the other engines is measured against.

``dtype=torch.bfloat16`` keeps the corpus on the device in bf16, as the
reference's ``FlatIndex(dtype=jnp.bfloat16)`` does: rows are normalized
(cosine) and |c|^2 taken (l2) in float32 before the cast, queries are cast
to bf16 before they are normalized, and bf16 products are summed in
float32.

Mutation follows the reference: the corpus is an id-indexed buffer with a
live mask; inserts append, deletes clear the mask, upserts overwrite in
place, all on the device. A bf16 engine stores each written row as the
float32 row (normalized for cosine) cast to bf16, which is what the
reference's ``_sync`` makes of its float32 mirror.
"""
from __future__ import annotations

import torch

from repro_torch.core import distances as D
from repro_torch.core.mutable import GrowableRows, MutationMixin
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
LOAD_CHUNK = 1 << 18  # rows a chunk when a bf16 corpus is built at load


def corpus_dtype(dtype) -> torch.dtype:
    """torch.float32 or torch.bfloat16, given as a torch dtype or its name;
    anything else raises."""
    name = str(dtype).replace("torch.", "")
    if name not in DTYPES:
        raise ValueError(f"flat corpus dtype must be one of {sorted(DTYPES)},"
                         f" got {dtype}")
    return DTYPES[name]


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
    """Exact-kNN engine (Thistle's Iterative, every metric). The corpus in
    ``dtype`` (float32 or bfloat16), |c|^2 for l2 in float32, and a live
    mask live on ``device``; queries scan the whole buffer with the mask
    knocking out dead and unfilled rows."""

    def __init__(self, metric: str = "cosine", dtype=torch.float32,
                 device=None):
        if metric not in D.METRICS:
            raise ValueError(f"metric {metric!r} not in {D.METRICS}")
        self.metric = metric
        self.dtype = corpus_dtype(dtype)
        self.device = resolve_device(device)
        self.corpus = self.corpus_sq = self.valid = None
        self._corpus = self._sq = self._valid = None
        self._mut_init(0)

    @property
    def size(self) -> int:
        return 0 if self._valid is None else int(self._valid.data.sum())

    @property
    def shape_key(self) -> tuple:
        return (0 if self._corpus is None else self._corpus.capacity,)

    def _init_storage(self, corpus, sq, live) -> None:
        self._corpus = GrowableRows.from_array(corpus)
        self._sq = None if sq is None else GrowableRows.from_array(sq)
        self._valid = GrowableRows.from_array(live)
        self._mut_init(corpus.shape[0])
        self._sync()

    def load(self, vectors):
        x = torch.as_tensor(vectors, dtype=torch.float32, device=self.device)
        if self.dtype == torch.float32:
            corpus, sq = D.preprocess_corpus(x, self.metric)
        else:  # float32 rows a chunk at a time, cast into the bf16 corpus
            corpus = torch.empty(x.shape, dtype=self.dtype, device=self.device)
            sq = (torch.empty(x.shape[0], dtype=torch.float32,
                              device=self.device)
                  if self.metric == "l2" else None)
            for a in range(0, x.shape[0], LOAD_CHUNK):
                rows, part = D.preprocess_corpus(x[a:a + LOAD_CHUNK],
                                                 self.metric)
                corpus[a:a + LOAD_CHUNK] = rows
                if sq is not None:
                    sq[a:a + LOAD_CHUNK] = part
        self._init_storage(corpus, sq, torch.ones(x.shape[0], dtype=torch.bool,
                                                  device=self.device))
        return self

    # ---------------------------------------------------------- mutation
    def _encode_batch(self, vectors):
        x = torch.atleast_2d(torch.as_tensor(vectors, dtype=torch.float32,
                                             device=self.device))
        return D.preprocess_corpus(x, self.metric)

    def _write_rows(self, ids, rows, sq) -> None:
        live = torch.ones_like(ids, dtype=torch.bool)
        self._write_mirrors(ids, ((self._corpus, rows), (self._sq, sq),
                                  (self._valid, live)))

    def insert(self, vectors, ids=None) -> torch.Tensor:
        rows, sq = self._encode_batch(vectors)
        ids = self._take_ids(rows.shape[0], ids)
        self._write_rows(ids, rows, sq)
        self._record("inserts", ids.numel())
        return ids

    def delete(self, ids) -> int:
        n = self._tombstone_valid(ids).numel()
        if n:
            self._record("deletes", n)
        return n

    def upsert(self, vectors, ids) -> torch.Tensor:
        rows, sq = self._encode_batch(vectors)
        ids = self._check_upsert_ids(rows.shape[0], ids)
        self._write_rows(ids, rows, sq)
        self._record("upserts", ids.numel())
        return ids

    def compact(self) -> dict:
        """Ids are addresses here: nothing repacks, the mask already knocks
        dead rows out of the scan. Counted, as in the reference."""
        self._record("compactions", 1)
        return {"dropped_tombstones": 0}

    def reserve(self, extra_rows: int) -> tuple:
        """Grow every buffer once to hold ``extra_rows`` more ids."""
        self._reserve_mirrors(extra_rows, (self._corpus, self._sq,
                                           self._valid))
        return self.shape_key

    # ------------------------------------------------------------- query
    def _sync(self) -> None:
        if not self._dirty:
            return
        self.corpus = self._corpus.data
        self.corpus_sq = None if self._sq is None else self._sq.data
        self.valid = self._valid.data.clone()
        self.valid[self._valid.n:] = False
        self._dirty = False

    def query(self, q, k: int = 10, *, allowed=None):
        """``allowed`` (the predicate bitmap over the id space) ANDs into
        the live mask: a filtered-out row is knocked out like a
        tombstone."""
        self._sync()
        q = torch.atleast_2d(torch.as_tensor(q, dtype=torch.float32,
                                             device=self.device))
        valid = kops.and_allowed(self.valid, allowed, self.valid.shape[0])
        return flat_search(self.corpus, q.to(self.dtype), metric=self.metric,
                           k=k, corpus_sq=self.corpus_sq, valid=valid)

    # ------------------------------------------------------- persistence
    def state_dict(self) -> dict:
        n = self.next_id
        state = {"engine": "flat", "metric": self.metric,
                 "dtype": str(self.dtype).replace("torch.", ""),
                 "corpus": self._corpus.data[:n],
                 "live": self._valid.data[:n],
                 "generation": self.generation}
        if self._sq is not None:
            state["corpus_sq"] = self._sq.data[:n]
        return state

    def load_state(self, state) -> "FlatIndex":
        """Load a state (``state_dict`` or ``core.convert.from_reference_state``):
        corpus rows as stored (already normalized for cosine), cast to the
        engine's dtype as the reference casts its float32 mirror. A state
        that names another dtype is refused."""
        _check_snapshot(state, "flat", self.metric)
        got = corpus_dtype(state.get("dtype", self.dtype))
        if got != self.dtype:
            raise ValueError(f"state holds a {got} corpus, cannot load into "
                             f"a {self.dtype} flat engine")
        dev = self.device
        sq = state.get("corpus_sq")
        self._init_storage(
            torch.as_tensor(state["corpus"], device=dev).to(self.dtype),
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
