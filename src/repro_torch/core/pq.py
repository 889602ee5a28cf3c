"""Product quantization and the IVF-PQ engine (port of ``repro.core.pq``,
the IVF-PQ load and query path).

PQ splits each d-dim vector into ``m`` subspaces, k-means-quantizes every
subspace to ``ksub`` (<= 256) centroids and stores one byte per subspace.
Queries stay full precision (asymmetric distance computation): a query
builds (m, ksub) tables of subspace partial scores, and a row's score is
m table lookups and a sum. ``IVFPQIndex`` puts an IVF coarse quantizer
over PQ codes of the residuals x - centroid, stored in the block-aligned
bucket-major layout, and re-ranks the best ``refine`` candidates exactly.

Scoring goes through ``kernels.ops.ivf_adc_topk``: the CUDA ``ivf_adc``
kernel on the card, its plain version on the CPU. The flat PQ engine, the
``scan_all`` path and ``pq_adc`` come with ROADMAP.md Queue 1, item 2.

Training and encoding walk the rows in chunks: the reference builds an
(N, ksub) score matrix per subspace and an (N, m, ksub) one to encode,
580 GB at 8.8M rows and m = 64.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core import distances as D
from repro_torch.core.flat import _check_snapshot
from repro_torch.core.ivf import (BlockListLayout, assign_clusters,
                                  assign_from_buckets, build_buckets, kmeans,
                                  row_chunk)
from repro_torch.core.mutable import GrowableRows, MutationMixin
from repro_torch.device import resolve_device, strict_fp32
from repro_torch.kernels import ops as kops


class ResidualRows:
    """The rows x - centroids[assign], made one slice at a time, so that
    training and encoding never hold a second corpus-sized tensor. Takes
    what ``kmeans``, ``train_pq`` and ``pq_encode`` ask of their input:
    ``shape``, ``device`` and row indexing."""

    def __init__(self, x, centroids, assign):
        self.x, self.centroids, self.assign = x, centroids, assign
        self.shape = x.shape
        self.device = x.device

    def __getitem__(self, rows):
        return self.x[rows] - self.centroids[self.assign[rows]]


def subspace_split(x, m: int):
    """x: (N, d) -> (N, m, dsub), zero-padding d up to a multiple of m."""
    N, d = x.shape
    dsub = -(-d // m)
    if m * dsub - d:
        x = F.pad(x, (0, m * dsub - d))
    return x.reshape(N, m, dsub)


@strict_fp32()
def _subspace_argmax(codebooks, xs):
    """xs: (n, m, dsub) -> (m, n) nearest codeword per subspace, argmax of
    2 x.c - |c|^2 (the reference's ``pq_encode`` rule)."""
    dots = torch.bmm(xs.transpose(0, 1), codebooks.transpose(1, 2))  # (m,n,ksub)
    c_sq = torch.sum(torch.square(codebooks), dim=-1)               # (m,ksub)
    return torch.argmax(2.0 * dots - c_sq[:, None, :], dim=-1)


def train_pq(x, *, m: int, ksub: int = 256, iters: int = 10, generator=None):
    """Per-subspace Lloyd k-means, all m subspaces at once. x: (N, d) rows
    -> codebooks (m, ksub, dsub) f32. Zero-padded tail dims train like real
    dims. ksub caps at N and 256 (codes are uint8)."""
    if ksub > 256:
        raise ValueError("codes are stored as uint8: ksub <= 256")
    N, d = x.shape
    ksub = min(ksub, N)
    gen_dev = generator.device if generator is not None else x.device
    init = torch.stack([torch.randperm(N, generator=generator,
                                       device=gen_dev)[:ksub]
                        for _ in range(m)]).to(x.device)       # (m, ksub)
    rows = subspace_split(x[init.reshape(-1)].float(), m)      # (m*ksub, m, dsub)
    rows = rows.reshape(m, ksub, m, -1)
    cb = rows[torch.arange(m), :, torch.arange(m), :]          # (m, ksub, dsub)
    dsub = cb.shape[-1]
    chunk = row_chunk(m * ksub)
    offs = (torch.arange(m, device=cb.device) * ksub)[:, None]
    for _ in range(iters):
        sums = torch.zeros((m * ksub, dsub), dtype=torch.float32, device=cb.device)
        cnts = torch.zeros(m * ksub, dtype=torch.float32, device=cb.device)
        for a in range(0, N, chunk):
            xs = subspace_split(x[a:a + chunk].float(), m)     # (n, m, dsub)
            idx = (_subspace_argmax(cb, xs) + offs).reshape(-1)
            sums.index_add_(0, idx, xs.transpose(0, 1).reshape(-1, dsub))
            cnts.index_add_(0, idx, torch.ones_like(idx, dtype=torch.float32))
        new = (sums / torch.clamp(cnts, min=1.0)[:, None]).reshape(m, ksub, dsub)
        cb = torch.where((cnts > 0).reshape(m, ksub, 1), new, cb)
    return cb


def pq_encode(codebooks, x):
    """x: (N, d) rows -> codes (N, m) uint8 (nearest centroid per
    subspace)."""
    m, ksub = codebooks.shape[:2]
    N = x.shape[0]
    out = torch.empty((N, m), dtype=torch.uint8, device=codebooks.device)
    chunk = row_chunk(m * ksub)
    for a in range(0, N, chunk):
        xs = subspace_split(x[a:a + chunk].float(), m)
        out[a:a + chunk] = _subspace_argmax(codebooks, xs).T.to(torch.uint8)
    return out


@strict_fp32()
def adc_tables(codebooks, q, *, metric: str):
    """Per-query subspace score tables. q: (Q, d) -> luts (Q, m, ksub) f32.

    dot:  lut[q, j, c] = q_j . c
    l2:   lut[q, j, c] = -|q_j - c|^2
    Higher = closer, matching every other engine's score convention.
    """
    m = codebooks.shape[0]
    qs = subspace_split(q.float(), m)                              # (Q, m, dsub)
    dots = torch.einsum("qmd,mkd->qmk", qs, codebooks)
    if metric == "dot":
        return dots
    if metric != "l2":
        raise ValueError(f"adc_tables metric {metric!r} not in (dot, l2)")
    c_sq = torch.sum(torch.square(codebooks), dim=-1)               # (m, ksub)
    q_sq = torch.sum(torch.square(qs), dim=-1)                      # (Q, m)
    return -(q_sq[:, :, None] - 2.0 * dots + c_sq[None])


@strict_fp32()
def _exact_rerank(corpus, corpus_sq, cand, q, *, metric: str, k: int):
    """Re-score the candidates exactly and re-sort. cand: (Q, R) ids
    (-1 = pad). Returns (scores (Q, k), ids (Q, k))."""
    valid = cand >= 0
    safe = torch.where(valid, cand, 0).long()
    vecs = corpus[safe].float()                                     # (Q, R, d)
    dots = torch.bmm(vecs, q.float()[:, :, None])[..., 0]
    if metric == "dot":
        scores = dots
    else:
        sq = (corpus_sq[safe] if corpus_sq is not None
              else torch.sum(torch.square(vecs), -1))
        q_sq = torch.sum(torch.square(q.float()), -1)
        scores = -(q_sq[:, None] - 2.0 * dots + sq)
    scores = torch.where(valid, scores, -torch.inf)
    s, pos = D.topk_scores(scores, min(k, scores.shape[-1]))
    ids = torch.gather(cand, 1, pos)
    return _pad_to_k(*D.mask_invalid_ids(s, ids), k)


def _pad_to_k(s, ids, k: int):
    kk = s.shape[-1]
    if kk < k:
        s = F.pad(s, (0, k - kk), value=-torch.inf)
        ids = F.pad(ids, (0, k - kk), value=-1)
    return s, ids


def expand_visit(probe, block_table, *, steps_per_probe: int, pad_block):
    """Probe ids -> (Q, nprobe * steps_per_probe) visit table of inverted-
    list block ids. ``block_table`` (C, steps_per_probe) lists the storage
    blocks cluster c owns in visit order, -1 = absent; absent steps (tails
    of short clusters) point at ``pad_block``, the shared all-pad row."""
    Q, nprobe = probe.shape
    rows = block_table[probe]                                       # (Q, nprobe, spp)
    return torch.where(rows >= 0, rows, pad_block).reshape(
        Q, nprobe * steps_per_probe).to(torch.int32)


def block_table_from_ranges(bstart, bcnt, steps_per_probe: int):
    """(bstart, bcnt) contiguous ranges (``build_block_lists`` output) ->
    the explicit (C, steps_per_probe) block table ``expand_visit`` reads."""
    bstart = torch.as_tensor(bstart).to(torch.int32)
    bcnt = torch.as_tensor(bcnt).to(torch.int32)
    r = torch.arange(steps_per_probe, dtype=torch.int32,
                     device=bstart.device)[None, :]
    return torch.where(r < bcnt[:, None], bstart[:, None] + r, -1)


def probe_luts(codebooks, centroids, q, probe, c_scores, *, metric: str):
    """(luts, coarse) for the bucket-resident dispatch, per metric:
      dot: one shared (Q, m, ksub) LUT; coarse[q, p] = q . centroid_p
           (c_scores for dot IS q . centroids, so it's a gather).
      l2:  per-(query, probe) residual LUTs on t = q - centroid_p,
           coarse None (ivf_adc_topk zero-fills)."""
    Q, nprobe = probe.shape
    m = codebooks.shape[0]
    if metric == "dot":
        return (adc_tables(codebooks, q, metric="dot"),
                torch.gather(c_scores, 1, probe))
    t = q[:, None, :] - centroids[probe]                            # (Q, nprobe, d)
    luts = adc_tables(codebooks, t.reshape(Q * nprobe, -1), metric="l2")
    return luts.reshape(Q, nprobe, m, -1), None


def _ivf_probe_stage(codebooks, centroids, q, block_table, *, metric: str,
                     nprobe: int, steps_per_probe: int, pad_block: int):
    """Coarse stage of ivf_pq_search: score centroids, pick the best
    ``nprobe`` (ties to the lower cluster), expand the visit table, build
    (luts, coarse)."""
    c_scores = D.pairwise_scores(q, centroids,
                                 metric if metric == "dot" else "l2")
    _, probe = D.topk_scores(c_scores, nprobe)
    visit = expand_visit(probe, block_table, steps_per_probe=steps_per_probe,
                         pad_block=pad_block)
    luts, coarse = probe_luts(codebooks, centroids, q, probe, c_scores,
                              metric=metric)
    if coarse is None:
        coarse = torch.zeros((q.shape[0], nprobe), dtype=torch.float32,
                             device=q.device)
    return visit, luts, coarse


def ivf_pq_search(codebooks, centroids, block_lists, corpus, q, *,
                  metric: str, k: int, nprobe: int, refine: int = 0,
                  corpus_sq=None, steps_per_probe: int = 1,
                  lut_dtype: str = "float32", adc_mode: str = "per_query",
                  scan_all: bool = False):
    """IVF-ADC: probe nprobe coarse buckets, ADC-score their residual
    codes, re-rank the best ``refine`` exactly.

    Residual geometry per probed bucket:
      dot: q.x = q.centroid_p + q.residual   -> one LUT on q, plus the
           per-probe scalar q.centroid_p as the coarse term.
      l2:  |q - x|^2 = |(q - centroid_p) - residual|^2 -> per-(query,
           probe) LUTs on t = q - centroid_p.

    ``block_lists`` is (bucket_codes (B, blk, m), bucket_ids (B, blk),
    block_table (C, steps_per_probe)) whose last storage row is the shared
    all-pad block; ``block_table_from_ranges`` turns the contiguous ranges
    of ``build_block_lists`` into that table. Returns (scores (Q, k), ids (Q, k)); pad slots are
    -inf / -1.
    """
    if scan_all:
        raise NotImplementedError(
            "scan_all needs the flat pq_adc kernel, which comes with "
            "ROADMAP.md Queue 1, item 2")
    q = q.float()
    bucket_codes, bucket_ids, block_table = block_lists
    spp = steps_per_probe
    blk = bucket_codes.shape[1]
    pad_block = bucket_ids.shape[0] - 1
    visit, luts, coarse = _ivf_probe_stage(
        codebooks, centroids, q, block_table, metric=metric, nprobe=nprobe,
        steps_per_probe=spp, pad_block=pad_block)
    R = min(max(refine, k), nprobe * spp * blk)
    s, ids = kops.ivf_adc_topk(bucket_codes, bucket_ids, visit, luts, k=R,
                               coarse=coarse, steps_per_probe=spp,
                               lut_dtype=lut_dtype, mode=adc_mode)
    if refine:
        return _exact_rerank(corpus, corpus_sq, ids, q, metric=metric, k=k)
    return _pad_to_k(s[:, :k], ids[:, :k], k)


class IVFPQIndex(MutationMixin):
    """IVF coarse quantizer over PQ-coded residuals + exact re-ranking
    (FAISS IVFADC). Codes live in the block-aligned bucket-major layout
    (``core.ivf.BlockListLayout``) on ``device``, and the f32 corpus stays
    there too for the re-rank when ``refine`` > 0."""

    def __init__(self, metric: str = "cosine", n_clusters: int = 0,
                 nprobe: int = 8, m: int = 8, ksub: int = 256,
                 kmeans_iters: int = 10, refine: int = 32, seed: int = 0,
                 lut_dtype: str = "float32",
                 block_size: int = 32, adc_mode: str = "per_query",
                 device=None):
        if metric not in D.METRICS:
            raise ValueError(f"metric {metric!r} not in {D.METRICS}")
        if lut_dtype not in kops.ADC_LUT_DTYPES:
            raise ValueError(f"lut_dtype {lut_dtype!r} not in "
                             f"{kops.ADC_LUT_DTYPES}")
        if adc_mode not in kops.ADC_MODES:
            raise ValueError(f"adc_mode {adc_mode!r} not in {kops.ADC_MODES}")
        self.metric = metric
        self.n_clusters = n_clusters  # 0 => sqrt(N) at load time
        self.nprobe = nprobe
        self.m = m
        self.ksub = ksub
        self.kmeans_iters = kmeans_iters
        self.refine = refine
        self.seed = seed
        self.lut_dtype = lut_dtype
        self.block_size = block_size
        self.adc_mode = adc_mode
        self.device = resolve_device(device)
        self.codebooks = self.centroids = None
        self.codes_bm = self.bucket_ids = self.block_table = None
        self.layout = None
        self.spp = 1
        self._corpus = self._sq = None
        self.corpus = self.corpus_sq = None
        self.d = 0
        self.n = 0
        self._mut_init(0)

    @property
    def size(self) -> int:
        return 0 if self.layout is None else int(self.layout.live)

    def _finalize_layout(self, codes, assign, live=None):
        """Build the block layout (load and load_state both land here)."""
        self.layout = BlockListLayout.from_assign(
            assign, self.centroids.shape[0], blk=self.block_size,
            payload=codes, live=live, device=self.device)
        self.n = codes.shape[0]
        self._mut_init(self.n)
        self._sync()

    def load(self, vectors):
        x = torch.as_tensor(vectors, dtype=torch.float32, device=self.device)
        N, self.d = x.shape
        C = min(self.n_clusters or max(1, int(math.sqrt(N))), N)
        corpus, sq = D.preprocess_corpus(x, self.metric)
        del x  # a converted copy of the input goes now, not after training
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        cent = kmeans(corpus, n_clusters=C, iters=self.kmeans_iters,
                      generator=gen)
        if self.metric == "cosine":
            cent = D.l2_normalize(cent)
        assign = assign_clusters(corpus, cent)
        residuals = ResidualRows(corpus, cent, assign)
        self.codebooks = train_pq(residuals, m=self.m, ksub=self.ksub,
                                  iters=self.kmeans_iters, generator=gen)
        self.centroids = cent
        self._corpus = GrowableRows.from_array(corpus) if self.refine else None
        self._sq = None if sq is None else GrowableRows.from_array(sq)
        self._finalize_layout(pq_encode(self.codebooks, residuals), assign)
        return self

    def _sync(self) -> None:
        if not self._dirty:
            return
        lay = self.layout
        self.codes_bm = lay.codes
        self.bucket_ids = lay.slots
        self.block_table = lay.block_table
        self.spp = lay.steps_per_probe
        self.corpus = None if self._corpus is None else self._corpus.data
        self.corpus_sq = None if self._sq is None else self._sq.data
        self._dirty = False

    def query(self, q, k: int = 10):
        self._sync()
        q = torch.atleast_2d(torch.as_tensor(q, dtype=torch.float32,
                                             device=self.device))
        metric = self.metric
        if metric == "cosine":
            q = D.l2_normalize(q)
            metric = "dot"
        return ivf_pq_search(
            self.codebooks, self.centroids,
            (self.codes_bm, self.bucket_ids, self.block_table), self.corpus,
            q, metric=metric, k=min(k, max(self.size, 1)),
            nprobe=min(self.nprobe, self.centroids.shape[0]),
            refine=self.refine, corpus_sq=self.corpus_sq,
            steps_per_probe=self.spp, lut_dtype=self.lut_dtype,
            adc_mode=self.adc_mode)

    # ------------------------------------------------------- persistence
    def state_dict(self) -> dict:
        """The reference's snapshot leaves: row-major codes and a bucket
        table of the live rows."""
        live = self.layout.live_mask(self.n)
        live_ids = torch.nonzero(live)[:, 0]
        buckets, _cap = build_buckets(self.layout.assign_of(self.n)[live_ids],
                                      self.centroids.shape[0], ids=live_ids)
        state = {"engine": "ivf_pq", "metric": self.metric,
                 "codebooks": self.codebooks,
                 "codes": self.layout.gather_payload(self.n),
                 "centroids": self.centroids, "buckets": buckets,
                 "live": live, "generation": self.generation, "d": self.d}
        if self._corpus is not None:
            state["corpus"] = self._corpus.data[: self.n]
        if self._sq is not None:
            state["corpus_sq"] = self._sq.data[: self.n]
        return state

    def load_state(self, state) -> "IVFPQIndex":
        """Load a state (``state_dict`` or
        ``core.convert.from_reference_state`` of a reference snapshot)."""
        _check_snapshot(state, "ivf_pq", self.metric)
        dev = self.device

        def f32(key):
            return torch.as_tensor(state[key], dtype=torch.float32, device=dev)

        self.codebooks = f32("codebooks")
        codes = torch.as_tensor(state["codes"], device=dev).to(torch.uint8)
        n = codes.shape[0]
        self.centroids = f32("centroids")
        self.d = int(state["d"])
        live = state.get("live")
        live = (torch.ones(n, dtype=torch.bool, device=dev) if live is None
                else torch.as_tensor(live, device=dev).bool().reshape(n))
        self._corpus = (GrowableRows.from_array(f32("corpus"))
                        if "corpus" in state else None)
        self._sq = (GrowableRows.from_array(f32("corpus_sq"))
                    if "corpus_sq" in state else None)
        if self._corpus is None:
            self.refine = 0
        buckets = torch.as_tensor(state["buckets"], device=dev)
        self._finalize_layout(codes, assign_from_buckets(buckets, n), live=live)
        self.generation = int(state.get("generation", 0))
        self.m = int(self.codebooks.shape[0])
        self.ksub = int(self.codebooks.shape[1])
        return self
