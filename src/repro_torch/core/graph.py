"""Graph-beam ANN: a fixed-degree kNN graph and batched beam search (port
of ``repro.core.graph``, the paper's HNSW adaptation (b)).

The graph is a table ``neighbors: (N, deg) int32``. A query seeds its beam
from a coarse entry scan over every ``entry_stride``-th row (the upper
layer), then each hop gathers the beam's neighbors, scores them with one
batched product, drops duplicate ids and keeps the best ``beam``.

Two parts run the ``topk_distance`` kernel on the card:

  * the build (``build_knn_graph``) scans each chunk of rows through the
    port's ``flat_search``. Above ``max_candidates`` rows each chunk
    searches a fresh sample of that many rows, drawn by numpy from
    ``seed`` in chunk order, as the reference draws them, so both packages
    build the same graph. The samples are uploaded from pinned memory
    without a wait, so the host draws the next chunk's while the card
    scans. ``_symmetrize`` then runs on the device.
  * the entry scan scores the queries against a contiguous copy of
    ``corpus[::entry_stride]`` made at load. The reference gathers that
    subsample for every query. The copy's rows rise with their ids, so
    the kernel's lower-row tie order is the reference's order.

The hops are plain batched products and stable sorts.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core import distances as D
from repro_torch.core.flat import _check_snapshot, corpus_dtype, flat_search
from repro_torch.device import resolve_device, strict_fp32
from repro_torch.kernels import ops as kops


def _not_self_first(ids, start: int, deg: int):
    """Stable-partition each row: ids other than the row's own first, keep
    ``deg``."""
    own = torch.arange(start, start + ids.shape[0], device=ids.device)[:, None]
    order = torch.sort((ids == own).to(torch.uint8), dim=-1,
                       stable=True).indices
    return torch.gather(ids, 1, order)[:, :deg]


def build_knn_graph(corpus, *, degree: int, metric: str = "cosine",
                    chunk: int = 1024, max_candidates: int | None = None,
                    seed: int = 0, use_kernel=None, stats: dict | None = None):
    """Offline kNN graph build: (N, d) -> neighbors (N, degree) int32.

    Runs the flat engine corpus-against-corpus a chunk of rows at a time
    and drops self-edges (degree + 1 taken, then the row's own id moved
    out). Above ``max_candidates`` rows each chunk searches a fresh sorted
    sample of that many rows (``np.random.default_rng(seed).choice``, one
    draw a chunk, in chunk order) and the table is symmetrized. ``stats``
    (a dict) gets the build's split: host seconds drawing samples
    (``draw_s``), seconds in the chunk loop (``scan_s``, synchronized
    at its end), symmetrize seconds and the chunk count; on the card also
    ``device_s``, each chunk's device span (a CUDA event before its upload
    and one after its last write, so host launch gaps inside a chunk
    count, the draws between chunks do not), summed over the chunks.
    """
    N = corpus.shape[0]
    dev = corpus.device
    # the kernel's width (``distances.pad_width``): one copy for the build
    # when d is not a multiple of 8; |c|^2 is taken before, the same
    sq = (torch.sum(torch.square(corpus.float()), dim=-1)
          if metric == "l2" else None)
    corpus = D.pad_width(corpus)
    subsample = max_candidates is not None and N > max_candidates
    deg = min(degree, (max_candidates if subsample else N) - 1)
    rng = np.random.default_rng(seed) if subsample else None
    nbrs = torch.empty((N, deg), dtype=torch.int32, device=dev)
    draw_s = 0.0
    spans = [] if stats is not None and dev.type == "cuda" else None
    t0 = time.perf_counter()
    for start in range(0, N, chunk):
        qc = corpus[start:start + chunk]
        if subsample:
            t1 = time.perf_counter()
            host = np.sort(rng.choice(N, size=max_candidates, replace=False))
            draw_s += time.perf_counter() - t1
            cand_ids = torch.from_numpy(host)
            if dev.type == "cuda":
                cand_ids = cand_ids.pin_memory()
        if spans is not None:
            spans.append((torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True)))
            spans[-1][0].record()
        if subsample:
            cand_ids = cand_ids.to(dev, non_blocking=True)
            _, local = flat_search(
                corpus[cand_ids], qc, metric=metric, k=deg + 1,
                corpus_sq=None if sq is None else sq[cand_ids],
                use_kernel=use_kernel)
            ids = cand_ids[local.long()]
        else:
            _, ids = flat_search(corpus, qc, metric=metric, k=deg + 1,
                                 corpus_sq=sq, use_kernel=use_kernel)
        nbrs[start:start + qc.shape[0]] = _not_self_first(ids.long(), start,
                                                          deg)
        if spans is not None:
            spans[-1][1].record()
    _synchronize(dev)
    t_scan = time.perf_counter()
    if subsample:
        nbrs = _symmetrize(nbrs, N)
        _synchronize(dev)
    t_sym = time.perf_counter()
    if deg < degree:  # tiny corpus or tight cap: pad with edge repeats
        nbrs = torch.cat([nbrs, nbrs[:, -1:].expand(N, degree - deg)], dim=1)
    if stats is not None:
        stats.update(draw_s=draw_s, scan_s=t_scan - t0,
                     symmetrize_s=t_sym - t_scan,
                     chunks=-(-N // chunk), subsample=subsample)
        if spans is not None:
            stats["device_s"] = sum(a.elapsed_time(b) for a, b in spans) / 1e3
    return nbrs.to(torch.int32)


def _synchronize(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _symmetrize(nbrs, N: int, frac: int = 4):
    """Rewrite each row's last deg / frac slots with reverse edges (v gets
    u for edges u -> v): sort the edges by target stably, rank them within
    their target, and keep each target's first few. The reference's numpy
    version, on the device: the same stable order, so the same table."""
    deg = nbrs.shape[1]
    r = max(1, deg // frac)
    vs = nbrs.reshape(-1).long()
    vs_s, order = torch.sort(vs, stable=True)
    us_s = torch.div(order, deg, rounding_mode="floor")   # the edge's row
    starts = torch.searchsorted(vs_s, torch.arange(N, device=vs.device))
    rank = torch.arange(vs_s.numel(), device=vs.device) - starts[vs_s]
    keep = rank < r
    out = nbrs.clone()
    # every write puts u into row v for an edge u -> v with u != v (the
    # build dropped self-edges), so no self-edge appears here
    out[vs_s[keep], deg - r + rank[keep]] = us_s[keep].to(nbrs.dtype)
    return out


def _dedup_topk(ids, scores, k: int):
    """Top-k by score with duplicate ids knocked out (the first copy in id
    order kept)."""
    ids_s, order = torch.sort(ids, dim=-1, stable=True)
    sc_s = torch.gather(scores, -1, order)
    dup = torch.zeros_like(ids_s, dtype=torch.bool)
    dup[..., 1:] = ids_s[..., 1:] == ids_s[..., :-1]
    sc_s = torch.where(dup, -torch.inf, sc_s)
    s, pos = D.topk_scores(sc_s, k)
    return torch.gather(ids_s, -1, pos), s


def entry_rows(corpus, corpus_sq, stride: int):
    """The entry scan's rows: a contiguous copy of corpus[::stride] (and
    its |c|^2), zero-padded to the kernel's width
    (``distances.pad_width``)."""
    rows = D.pad_width(corpus[::stride].contiguous())
    return rows, None if corpus_sq is None else corpus_sq[::stride].contiguous()


@strict_fp32()
def beam_search(corpus, neighbors, q, *, metric: str, k: int, beam: int = 32,
                n_hops: int = 8, entry_stride: int = 64, n_entry: int = 4,
                corpus_sq=None, entry=None, use_kernel=None):
    """Batched beam search. corpus (N, d); neighbors (N, deg); q (Q, d) ->
    (scores (Q, k), ids (Q, k)). ``entry`` is ``entry_rows(corpus,
    corpus_sq, entry_stride)`` (made here when None); ``use_kernel`` goes
    to the entry scan's ``topk_distance`` (False: its plain version)."""
    N = corpus.shape[0]
    Q = q.shape[0]
    deg = neighbors.shape[1]
    beam = min(beam, N)
    if metric == "cosine":
        q = D.l2_normalize(q)
        metric = "dot"

    # entry: the coarse upper layer, every entry_stride-th row
    rows, rows_sq = entry if entry is not None else entry_rows(
        corpus, corpus_sq, entry_stride)
    n_e = min(n_entry, rows.shape[0])
    _, e_pos = kops.topk_distance(rows, D.pad_width(q), k=n_e, metric=metric,
                                  corpus_sq=rows_sq, use_kernel=use_kernel)
    seeds = e_pos.long() * entry_stride                         # (Q, n_e)
    beam_ids = torch.cat([seeds, seeds[:, -1:].expand(Q, beam - n_e)], dim=1)
    beam_ids, beam_scores = _dedup_topk(
        beam_ids, D.score_rows(corpus, corpus_sq, beam_ids, q, metric), beam)
    for _ in range(n_hops):
        nb = neighbors[beam_ids.clamp(min=0)].reshape(Q, beam * deg).long()
        cand = torch.cat([beam_ids, nb], dim=-1)
        cand_s = torch.cat(
            [beam_scores, D.score_rows(corpus, corpus_sq, nb, q, metric)],
            dim=-1)
        beam_ids, beam_scores = _dedup_topk(cand, cand_s, beam)
    kk = min(k, beam)
    s, pos = D.topk_scores(beam_scores, kk)
    return D.pad_to_k(s, torch.gather(beam_ids, 1, pos).to(torch.int32), k)


class GraphIndex:
    """kNN graph + batched beam search. The corpus (in ``dtype``), |c|^2
    for l2, the neighbor table and the entry rows live on ``device``."""

    def __init__(self, metric: str = "cosine", degree: int = 16,
                 beam: int = 32, n_hops: int = 8, entry_stride: int = 64,
                 n_entry: int = 4, dtype=torch.float32,
                 max_build_candidates: int | None = 16384, device=None):
        if metric not in D.METRICS:
            raise ValueError(f"metric {metric!r} not in {D.METRICS}")
        self.metric = metric
        self.degree = degree
        self.beam = beam
        self.n_hops = n_hops
        self.entry_stride = entry_stride
        self.n_entry = n_entry
        self.dtype = corpus_dtype(dtype)
        # above this N the exact build samples candidates (None: exact)
        self.max_build_candidates = max_build_candidates
        self.device = resolve_device(device)
        self.corpus = self.neighbors = self.corpus_sq = self.entry = None
        self.build_stats = None

    @property
    def size(self) -> int:
        return 0 if self.corpus is None else int(self.corpus.shape[0])

    def load(self, vectors, use_kernel=None):
        x = torch.as_tensor(vectors, dtype=torch.float32, device=self.device)
        corpus, sq = D.preprocess_corpus(x, self.metric)
        del x
        self.build_stats = {}
        neighbors = build_knn_graph(
            corpus, degree=self.degree,
            metric="dot" if self.metric == "cosine" else self.metric,
            max_candidates=self.max_build_candidates, use_kernel=use_kernel,
            stats=self.build_stats)
        return self._adopt(corpus.to(self.dtype), sq, neighbors)

    def _adopt(self, corpus, sq, neighbors) -> "GraphIndex":
        self.corpus, self.corpus_sq, self.neighbors = corpus, sq, neighbors
        self.entry = entry_rows(corpus, sq, self._stride())
        return self

    def _stride(self) -> int:
        return min(self.entry_stride, self.corpus.shape[0])

    def load_state(self, state) -> "GraphIndex":
        """The neighbor table, the corpus (normalized for cosine; cast to
        the engine's dtype) and corpus_sq for l2. The reference's engine
        has no ``state_dict``: a caller builds the dict from its attributes
        and passes it through ``core.convert.from_reference_state``."""
        _check_snapshot(state, "graph", self.metric)
        dev = self.device
        sq = state.get("corpus_sq")
        return self._adopt(
            torch.as_tensor(state["corpus"], device=dev).to(self.dtype),
            None if sq is None else torch.as_tensor(sq, dtype=torch.float32,
                                                    device=dev),
            torch.as_tensor(state["neighbors"], device=dev).to(torch.int32))

    def query(self, q, k: int = 10, *, use_kernel=None):
        q = torch.atleast_2d(torch.as_tensor(q, dtype=torch.float32,
                                             device=self.device))
        N = self.corpus.shape[0]
        return beam_search(
            self.corpus, self.neighbors, q.to(self.dtype), metric=self.metric,
            k=k, beam=min(self.beam, N), n_hops=self.n_hops,
            entry_stride=self._stride(), n_entry=self.n_entry,
            corpus_sq=self.corpus_sq, entry=self.entry, use_kernel=use_kernel)

    def memory_bytes(self) -> int:
        """Corpus, |c|^2, neighbor table and entry rows on the device."""
        parts = [self.corpus, self.corpus_sq, self.neighbors, *self.entry]
        return int(sum(t.numel() * t.element_size() for t in parts
                       if t is not None))
