"""Product quantization and the PQ engines (port of ``repro.core.pq``,
the load and query paths of ``PQIndex`` and ``IVFPQIndex``).

PQ splits each d-dim vector into ``m`` subspaces, k-means-quantizes every
subspace to ``ksub`` (<= 256) centroids and stores one byte per subspace.
Queries stay full precision (asymmetric distance computation): a query
builds (m, ksub) tables of subspace partial scores, and a row's score is
m table lookups and a sum.

  * ``PQIndex``: the flat ADC scan over all N codes
    (``kernels.ops.adc_topk``: the CUDA ``pq_adc`` kernel on the card).
  * ``IVFPQIndex``: an IVF coarse quantizer over PQ codes of the residuals
    x - centroid, stored in the block-aligned bucket-major layout and
    scanned by ``kernels.ops.ivf_adc_topk`` on one of its three grids;
    ``scan_all`` instead folds the coarse term into the flat scan.

Both re-rank the best ``refine`` candidates exactly when they keep the
corpus. Training and encoding walk the rows in chunks: the reference
builds an (N, ksub) score matrix per subspace and an (N, m, ksub) one to
encode, 580 GB at 8.8M rows and m = 64.

Both take writes as the reference does: rows are encoded with the frozen
codebooks (and, for IVF-PQ, assigned to the frozen centroids) and
appended on the device; ``PQIndex`` counts the rows its codebooks never
saw (``stale_fraction``, ``needs_retrain``), ``IVFPQIndex`` appends into
its block layout and compacts past ``compact_threshold`` tombstones.
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
from repro_torch.core.mutable import GrowableRows, MutationMixin, as_ids
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


def pq_decode(codebooks, codes, *, d: int):
    """codes: (N, m) -> reconstruction (N, d) from the codebook centroids."""
    m = codebooks.shape[0]
    rec = codebooks[torch.arange(m, device=codes.device)[None, :],
                    codes.long()]                                  # (N, m, dsub)
    return rec.reshape(codes.shape[0], -1)[:, :d]


def adc_scores(luts, codes):
    """Dense ADC scores, the plain oracle. luts: (Q, m, ksub); codes:
    (N, m) -> (Q, N) f32, m gathers summed in j order."""
    idx = codes.long().T                                           # (m, N)
    total = torch.zeros((luts.shape[0], idx.shape[1]), dtype=torch.float32,
                        device=luts.device)
    for j in range(idx.shape[0]):
        total = total + luts[:, j, idx[j]]
    return total


def pq_topk(luts, codes, *, k: int, tile: int = 4096, valid=None):
    """Flat ADC top-k over all codes in row tiles, the plain oracle (the
    reference's scanned ``pq_topk``). luts: (Q, m, ksub); codes: (N, m)
    -> (scores (Q, k), ids (Q, k) int32); rows where ``valid`` is False
    score -inf. Peak memory O(Q * tile)."""
    N = codes.shape[0]
    k = min(k, N)
    best = None
    for start in range(0, N, tile):
        stop = min(start + tile, N)
        scores = adc_scores(luts, codes[start:stop])
        if valid is not None:
            scores = torch.where(valid[start:stop][None, :], scores, -torch.inf)
        s, pos = D.topk_scores(scores, min(k, stop - start))
        pos = pos + start
        best = (s, pos) if best is None else D.merge_topk(*best, s, pos, k)
    s, i = best
    return s, i.to(torch.int32)


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


def pq_search(codebooks, codes, corpus, q, *, metric: str, k: int,
              refine: int = 0, corpus_sq=None, valid=None, allowed=None,
              lut_dtype: str = "float32"):
    """Flat ADC search, with an exact re-rank of the best ``refine``.

    Tables on q, then ``kops.adc_topk`` (the ``pq_adc`` kernel on the
    card), then ``_exact_rerank``. ``valid`` masks dead rows out of the
    scan, and ``allowed`` (the predicate bitmap) ANDs into it; ``corpus``
    is read only when refine > 0. Returns (scores (Q, k),
    ids (Q, k)) with -inf / -1 where fewer than k rows are live.
    """
    N = codes.shape[0]
    luts = adc_tables(codebooks, q, metric=metric)
    if not refine:
        s, i = kops.adc_topk(codes, luts, k=k, valid=valid, allowed=allowed,
                             lut_dtype=lut_dtype)
        return D.mask_invalid_ids(s, i)
    R = min(max(refine, k), N)
    s, cand = kops.adc_topk(codes, luts, k=R, valid=valid, allowed=allowed,
                            lut_dtype=lut_dtype)
    _, cand = D.mask_invalid_ids(s, cand)
    return _exact_rerank(corpus, corpus_sq, cand, q, metric=metric, k=k)


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


@strict_fp32()
def scan_all_tables(codebooks, centroids, q):
    """(Q, m + 1, W) tables of the all-codes path: the m dot tables on q
    padded to W = max(ksub, C), then q . centroid_c as the last row, which
    each row's cluster id indexes."""
    ksub = codebooks.shape[1]
    C = centroids.shape[0]
    width = max(ksub, C)
    qc = q @ centroids.float().T                                    # (Q, C)
    luts = F.pad(adc_tables(codebooks, q, metric="dot"), (0, width - ksub))
    return torch.cat([luts, F.pad(qc, (0, width - C))[:, None, :]], dim=1)


@strict_fp32()
def _ivf_scan_all(codebooks, codes, centroids, corpus, corpus_sq, assign,
                  valid, q, *, metric: str, k: int, refine: int,
                  lut_dtype: str):
    """ivf_pq_search's all-codes path: the coarse term q . centroid folds
    into the flat ``adc_topk`` scan as an (m+1)-th subspace indexed by each
    row's cluster, and all N codes are scored (dot only). Every subspace's
    table row is padded to W = max(ksub, C)."""
    N = codes.shape[0]
    R = min(max(refine, k), N)
    s, ids = kops.adc_topk(codes, scan_all_tables(codebooks, centroids, q),
                           k=R, valid=valid, extra_codes=assign,
                           lut_dtype=lut_dtype)
    s, ids = D.mask_invalid_ids(s, ids)
    if refine:
        return _exact_rerank(corpus, corpus_sq, ids, q, metric=metric, k=k)
    return _pad_to_k(s[:, :k], ids[:, :k], k)


def _ivf_probe_stage(codebooks, centroids, q, block_table, *, metric: str,
                     nprobe: int, steps_per_probe: int, pad_block: int,
                     adaptive_nprobe=None):
    """Coarse stage of ivf_pq_search: score centroids, pick the best
    ``nprobe`` (ties to the lower cluster), expand the visit table, build
    (luts, coarse).

    ``adaptive_nprobe`` (a score gap, None = off) masks the probes whose
    coarse score trails the query's best probe by more than the gap:
    their visit steps point at the pad block (so the block schedule drops
    them) and their coarse term is NEG_INF (so the per-query grid skips
    them). Probe 0 always stays. Returns (visit, luts, coarse, eff_nprobe)
    with eff_nprobe the (Q,) count of probes kept."""
    c_scores = D.pairwise_scores(q, centroids,
                                 metric if metric == "dot" else "l2")
    c_top, probe = D.topk_scores(c_scores, nprobe)
    visit = expand_visit(probe, block_table, steps_per_probe=steps_per_probe,
                         pad_block=pad_block)
    luts, coarse = probe_luts(codebooks, centroids, q, probe, c_scores,
                              metric=metric)
    Q = q.shape[0]
    if coarse is None:
        coarse = torch.zeros((Q, nprobe), dtype=torch.float32,
                             device=q.device)
    if adaptive_nprobe is None:
        return visit, luts, coarse, torch.full((Q,), nprobe, dtype=torch.int32,
                                               device=q.device)
    active = (c_top[:, :1] - c_top) <= adaptive_nprobe
    active[:, 0] = True
    visit = torch.where(torch.repeat_interleave(active, steps_per_probe, dim=1),
                        visit, pad_block)
    coarse = torch.where(active, coarse, kops.NEG_INF)
    return visit, luts, coarse, active.sum(dim=1).to(torch.int32)


def ivf_pq_search(codebooks, centroids, block_lists, corpus, q, *,
                  metric: str, k: int, nprobe: int, refine: int = 0,
                  corpus_sq=None, steps_per_probe: int = 1,
                  lut_dtype: str = "float32", adc_mode: str = "auto",
                  qblk=None, adaptive_nprobe=None, adc_stats=None,
                  autotune=None, sched_cache=None, sched_key=(),
                  scan_all: bool = False, codes=None, assign=None,
                  valid=None, allowed=None):
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
    of ``build_block_lists`` into that table. ``adc_mode``, ``qblk``,
    ``autotune``, ``sched_cache`` and ``sched_key`` go to
    ``kops.ivf_adc_topk``; ``adaptive_nprobe`` to the probe stage.
    ``adc_stats`` (a dict) receives the grid decision and 'eff_nprobe',
    the mean count of probes kept (``nprobe``, with no sync, when adaptive
    probing is off).

    ``scan_all=True`` scores all N row-major ``codes`` instead, with the
    coarse term folded in through each row's ``assign`` (dot only;
    ``valid`` masks dead rows). ``allowed`` (the predicate bitmap over the
    id space) ANDs into ``valid`` on that path and rewrites the bucket ids
    on the bucket path (``kops.ivf_adc_topk``). Returns (scores (Q, k),
    ids (Q, k)); pad slots are -inf / -1.
    """
    q = q.float()
    if scan_all:
        if metric != "dot":
            raise ValueError("scan_all folds the coarse term into the flat "
                             "scan as an extra subspace: dot and cosine only")
        if codes is None or assign is None:
            raise ValueError("scan_all needs row-major codes and assignments "
                             "(IVFPQIndex keeps them with scan_all=True)")
        return _ivf_scan_all(codebooks, codes, centroids, corpus, corpus_sq,
                             assign,
                             kops.and_allowed(valid, allowed, codes.shape[0]),
                             q, metric=metric, k=k, refine=refine,
                             lut_dtype=lut_dtype)
    bucket_codes, bucket_ids, block_table = block_lists
    spp = steps_per_probe
    blk = bucket_codes.shape[1]
    pad_block = bucket_ids.shape[0] - 1
    visit, luts, coarse, eff = _ivf_probe_stage(
        codebooks, centroids, q, block_table, metric=metric, nprobe=nprobe,
        steps_per_probe=spp, pad_block=pad_block,
        adaptive_nprobe=adaptive_nprobe)
    R = min(max(refine, k), nprobe * spp * blk)
    s, ids = kops.ivf_adc_topk(bucket_codes, bucket_ids, visit, luts, k=R,
                               coarse=coarse, steps_per_probe=spp,
                               lut_dtype=lut_dtype, mode=adc_mode, qblk=qblk,
                               pad_block=pad_block, stats=adc_stats,
                               autotune=autotune, sched_cache=sched_cache,
                               sched_key=sched_key, allowed=allowed)
    if adc_stats is not None:
        adc_stats["eff_nprobe"] = (float(eff.float().mean())
                                   if adaptive_nprobe is not None
                                   else float(nprobe))
    if refine:
        return _exact_rerank(corpus, corpus_sq, ids, q, metric=metric, k=k)
    return _pad_to_k(s[:, :k], ids[:, :k], k)


class PQIndex(MutationMixin):
    """Flat product-quantized engine: m bytes a row, the ADC scan over all
    codes, and an exact re-rank of the best ``refine`` candidates when the
    corpus is kept (refine=0 keeps only codes and codebooks). Codes, the
    live mask and the corpus live on ``device``. Writes encode with the
    frozen codebooks; ``needs_retrain`` says when more than
    ``retrain_threshold`` of the live rows were encoded after training."""

    def __init__(self, metric: str = "cosine", m: int = 8, ksub: int = 256,
                 kmeans_iters: int = 10, refine: int = 32, seed: int = 0,
                 lut_dtype: str = "float32", retrain_threshold: float = 0.25,
                 device=None):
        if metric not in D.METRICS:
            raise ValueError(f"metric {metric!r} not in {D.METRICS}")
        if lut_dtype not in kops.ADC_LUT_DTYPES:
            raise ValueError(f"lut_dtype {lut_dtype!r} not in "
                             f"{kops.ADC_LUT_DTYPES}")
        self.metric = metric
        self.m = m
        self.ksub = ksub
        self.kmeans_iters = kmeans_iters
        self.refine = refine
        self.seed = seed
        self.lut_dtype = lut_dtype
        self.retrain_threshold = retrain_threshold
        self.device = resolve_device(device)
        self.codebooks = self.codes = self.corpus = self.corpus_sq = None
        self.valid = None
        self._codes = self._corpus = self._sq = self._valid = None
        self.d = 0
        self.inserted_since_train = 0
        self._mut_init(0)

    @property
    def size(self) -> int:
        return 0 if self._valid is None else int(self._valid.data.sum())

    @property
    def shape_key(self) -> tuple:
        return (0 if self._codes is None else self._codes.capacity,)

    @property
    def stale_fraction(self) -> float:
        """Fraction of live rows encoded after codebook training."""
        return self.inserted_since_train / max(self.size, 1)

    @property
    def needs_retrain(self) -> bool:
        return self.stale_fraction > self.retrain_threshold

    def _init_storage(self, codes, corpus, sq, live) -> None:
        self._codes = GrowableRows.from_array(codes)
        self._valid = GrowableRows.from_array(live)
        self._corpus = None if corpus is None else GrowableRows.from_array(corpus)
        self._sq = None if sq is None else GrowableRows.from_array(sq)
        self.inserted_since_train = 0
        self._mut_init(codes.shape[0])
        self._sync()

    def load(self, vectors):
        x = torch.as_tensor(vectors, dtype=torch.float32, device=self.device)
        self.d = x.shape[1]
        corpus, sq = D.preprocess_corpus(x, self.metric)
        del x
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        self.codebooks = train_pq(corpus, m=self.m, ksub=self.ksub,
                                  iters=self.kmeans_iters, generator=gen)
        codes = pq_encode(self.codebooks, corpus)
        self._init_storage(codes, corpus if self.refine else None, sq,
                           torch.ones(codes.shape[0], dtype=torch.bool,
                                      device=self.device))
        return self

    # ---------------------------------------------------------- mutation
    def _encode_batch(self, vectors):
        x = torch.atleast_2d(torch.as_tensor(vectors, dtype=torch.float32,
                                             device=self.device))
        rows, sq = D.preprocess_corpus(x, self.metric)
        return pq_encode(self.codebooks, rows), rows, sq

    def _write_rows(self, ids, codes, rows, sq) -> None:
        live = torch.ones_like(ids, dtype=torch.bool)
        self._write_mirrors(ids, ((self._codes, codes), (self._corpus, rows),
                                  (self._sq, sq), (self._valid, live)))

    def insert(self, vectors, ids=None) -> torch.Tensor:
        codes, rows, sq = self._encode_batch(vectors)
        ids = self._take_ids(codes.shape[0], ids)
        self._write_rows(ids, codes, rows, sq)
        self.inserted_since_train += ids.numel()
        self._record("inserts", ids.numel())
        return ids

    def delete(self, ids) -> int:
        n = self._tombstone_valid(ids).numel()
        if n:
            self._record("deletes", n)
        return n

    def upsert(self, vectors, ids) -> torch.Tensor:
        codes, rows, sq = self._encode_batch(vectors)
        ids = self._check_upsert_ids(codes.shape[0], ids)
        self._write_rows(ids, codes, rows, sq)
        self.inserted_since_train += ids.numel()
        self._record("upserts", ids.numel())
        return ids

    def compact(self) -> dict:
        """Ids are addresses into the code buffer: the live mask is the
        whole tombstone story, nothing repacks. Counted, as in the
        reference."""
        self._record("compactions", 1)
        return {"dropped_tombstones": 0}

    def reserve(self, extra_rows: int) -> tuple:
        """Grow every buffer once to hold ``extra_rows`` more ids."""
        self._reserve_mirrors(extra_rows, (self._codes, self._corpus,
                                           self._sq, self._valid))
        return self.shape_key

    # ------------------------------------------------------------- query
    def _sync(self) -> None:
        if not self._dirty:
            return
        self.codes = self._codes.data
        self.valid = self._valid.data.clone()
        self.valid[self._valid.n:] = False
        self.corpus = None if self._corpus is None else self._corpus.data
        self.corpus_sq = None if self._sq is None else self._sq.data
        self._dirty = False

    def query(self, q, k: int = 10, *, allowed=None):
        """``allowed``: the predicate bitmap over the id space."""
        self._sync()
        q = torch.atleast_2d(torch.as_tensor(q, dtype=torch.float32,
                                             device=self.device))
        metric = self.metric
        if metric == "cosine":
            q = D.l2_normalize(q)
            metric = "dot"  # corpus rows were normalized at load time
        return pq_search(self.codebooks, self.codes, self.corpus, q,
                         metric=metric, k=min(k, max(self.size, 1)),
                         refine=self.refine, corpus_sq=self.corpus_sq,
                         valid=self.valid, allowed=allowed,
                         lut_dtype=self.lut_dtype)

    # ------------------------------------------------------- persistence
    def state_dict(self) -> dict:
        """The reference's snapshot leaves."""
        n = self.next_id
        state = {"engine": "pq", "metric": self.metric,
                 "codebooks": self.codebooks, "codes": self._codes.data[:n],
                 "live": self._valid.data[:n],
                 "generation": self.generation, "d": self.d}
        if self._corpus is not None:
            state["corpus"] = self._corpus.data[:n]
        if self._sq is not None:
            state["corpus_sq"] = self._sq.data[:n]
        return state

    def load_state(self, state) -> "PQIndex":
        """Load a state (``state_dict`` or
        ``core.convert.from_reference_state`` of a reference snapshot)."""
        _check_snapshot(state, "pq", self.metric)
        dev = self.device

        def f32(key):
            return torch.as_tensor(state[key], dtype=torch.float32, device=dev)

        self.codebooks = f32("codebooks")
        codes = torch.as_tensor(state["codes"], device=dev).to(torch.uint8)
        n = codes.shape[0]
        self.d = int(state["d"])
        live = state.get("live")
        live = (torch.ones(n, dtype=torch.bool, device=dev) if live is None
                else torch.as_tensor(live, device=dev).bool().reshape(n))
        corpus = f32("corpus") if "corpus" in state else None
        if corpus is None:
            self.refine = 0
        self._init_storage(codes, corpus,
                           f32("corpus_sq") if "corpus_sq" in state else None,
                           live)
        self.generation = int(state.get("generation", 0))
        self.m = int(self.codebooks.shape[0])
        self.ksub = int(self.codebooks.shape[1])
        return self

    def memory_bytes(self, include_raw: bool = False) -> int:
        """Index-resident bytes: codes, live mask and codebooks (and |c|^2
        for l2, and the re-rank corpus with ``include_raw``)."""
        total = (self._codes.data.numel() + self._valid.data.numel()
                 + self.codebooks.numel() * 4)
        if self._sq is not None:
            total += self._sq.data.numel() * 4
        if include_raw and self._corpus is not None:
            total += self._corpus.data.numel() * 4
        return int(total)


class IVFPQIndex(MutationMixin):
    """IVF coarse quantizer over PQ-coded residuals + exact re-ranking
    (FAISS IVFADC). Codes live in the block-aligned bucket-major layout
    (``core.ivf.BlockListLayout``) on ``device``, and the f32 corpus stays
    there too for the re-rank when ``refine`` > 0.

    ``adc_mode`` picks the ADC grid (``kops.ADC_MODES``, 'auto' by
    default), ``qblk`` the grouped grids' group width (None = the
    autotuner's), ``adaptive_nprobe`` the coarse-score gap past which a
    probe is dropped (None = off). ``scan_all=True`` keeps row-major codes,
    assignments and a live mask beside the layout and scores all rows
    instead of probing (dot and cosine). ``adc_stats`` counts the batches
    each grid served; the owning ``VectorDB`` installs ``sched_cache`` and
    ``_sched_ctx``.

    Writes: an insert assigns, residual-encodes and appends into the
    layout; a delete tombstones the slots; an upsert tombstones the old
    slot and re-appends the row under its own id, maybe in another
    cluster; past ``compact_threshold`` tombstones (None = never) a write
    compacts the layout."""

    def __init__(self, metric: str = "cosine", n_clusters: int = 0,
                 nprobe: int = 8, m: int = 8, ksub: int = 256,
                 kmeans_iters: int = 10, refine: int = 32, seed: int = 0,
                 lut_dtype: str = "float32", scan_all: bool = False,
                 block_size: int = 32, compact_threshold: float = 0.3,
                 adc_mode: str = "auto", adaptive_nprobe=None, qblk=None,
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
        self.scan_all = scan_all
        self.block_size = block_size
        self.compact_threshold = compact_threshold
        self.adc_mode = adc_mode
        self.adaptive_nprobe = adaptive_nprobe
        self.qblk = qblk
        self.device = resolve_device(device)
        # batches served per grid (a probe batch counts under its grid and
        # under 'probes'), the last fitted crossover, and running sums of
        # the sharing factor and the effective nprobe
        self.adc_stats = {"blocked": 0, "per_query": 0, "run_resident": 0,
                          "probes": 0, "crossover": None,
                          "sharing_sum": 0.0, "eff_nprobe_sum": 0.0,
                          "batches": 0}
        self.sched_cache = None
        self._sched_ctx = ()
        self.codebooks = self.centroids = None
        self.codes = self.assign = self.valid = None  # scan_all's row-major view
        self._codes_rm = self._assign = self._valid = None
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

    @property
    def shape_key(self) -> tuple:
        if self.layout is None:
            return (0,)
        return self.layout.shape_key + (
            0 if self._corpus is None else self._corpus.capacity,)

    def _finalize_layout(self, codes, assign, live=None):
        """Build the block layout (load and load_state both land here);
        keep the row-major codes, assignments and live mask only for
        scan_all."""
        self.layout = BlockListLayout.from_assign(
            assign, self.centroids.shape[0], blk=self.block_size,
            payload=codes, live=live, device=self.device)
        if self.scan_all:
            self._codes_rm = GrowableRows.from_array(codes)
            self._assign = GrowableRows.from_array(assign.to(torch.int32))
            self._valid = GrowableRows.from_array(
                torch.ones(codes.shape[0], dtype=torch.bool, device=self.device)
                if live is None else live)
        else:
            self._codes_rm = self._assign = self._valid = None
            self.codes = self.assign = self.valid = None
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

    # ---------------------------------------------------------- mutation
    def _encode_batch(self, vectors):
        x = torch.atleast_2d(torch.as_tensor(vectors, dtype=torch.float32,
                                             device=self.device))
        rows, sq = D.preprocess_corpus(x, self.metric)
        assign = assign_clusters(rows, self.centroids)
        codes = pq_encode(self.codebooks, rows - self.centroids[assign])
        return codes, assign, rows, sq

    def _write_side(self, ids, assign, codes, rows, sq) -> None:
        live = torch.ones_like(ids, dtype=torch.bool)
        self._write_mirrors(ids, ((self._corpus, rows), (self._sq, sq),
                                  (self._codes_rm, codes),
                                  (self._assign, assign), (self._valid, live)))

    def insert(self, vectors, ids=None) -> torch.Tensor:
        """Assign, residual-encode, append into the layout."""
        codes, assign, rows, sq = self._encode_batch(vectors)
        ids = self._take_ids(codes.shape[0], ids)
        self.layout.insert_rows(ids, assign, codes)
        self._write_side(ids, assign, codes, rows, sq)
        self.n = self.next_id
        self._record("inserts", ids.numel())
        return ids

    def delete(self, ids) -> int:
        """Tombstone rows; returns the distinct live ids among ``ids``."""
        n = self.layout.delete_rows(ids)
        if self._valid is not None:
            dead = as_ids(ids, self.device)
            dead = dead[(dead >= 0) & (dead < self._valid.n)]
            self._valid.data[dead] = False
        if n:
            self._record("deletes", n)
            self._maybe_compact()
        return n

    def upsert(self, vectors, ids) -> torch.Tensor:
        """Re-encode existing ids: the old slot is tombstoned and the row
        re-appended under its own id in its (maybe different) cluster."""
        codes, assign, rows, sq = self._encode_batch(vectors)
        ids = self._check_upsert_ids(codes.shape[0], ids)
        self.layout.delete_rows(ids)
        self.layout.insert_rows(ids, assign, codes)
        self._write_side(ids, assign, codes, rows, sq)
        self._record("upserts", ids.numel())
        self._maybe_compact()
        return ids

    def _maybe_compact(self) -> None:
        if (self.compact_threshold is not None
                and self.layout.tombstone_fraction > self.compact_threshold):
            self.compact()

    def reserve(self, extra_rows: int,
                extra_blocks_per_cluster: int = 0) -> tuple:
        """Pre-size every buffer for a planned ingest volume: the layout's
        rows and steps per probe, and each row buffer once to
        ``extra_rows`` more ids. Returns the resulting shape_key."""
        self.layout.reserve(extra_rows, extra_blocks_per_cluster)
        self._reserve_mirrors(extra_rows, (self._corpus, self._sq,
                                           self._codes_rm, self._assign,
                                           self._valid))
        return self.shape_key

    def compact(self) -> dict:
        """Repack the block lists, dropping tombstones (capacities kept)."""
        stats = self.layout.compact()
        self._record("compactions", 1)
        return stats

    # ------------------------------------------------------------- query
    def _sync(self) -> None:
        if not self._dirty:
            return
        lay = self.layout
        self.codes_bm = lay.codes
        self.bucket_ids = lay.slots
        self.block_table = lay.block_table
        self.spp = lay.steps_per_probe
        if self.scan_all:
            self.codes = self._codes_rm.data
            self.assign = self._assign.data
            self.valid = self._valid.data
        self.corpus = None if self._corpus is None else self._corpus.data
        self.corpus_sq = None if self._sq is None else self._sq.data
        self._dirty = False

    def query(self, q, k: int = 10, *, allowed=None, nprobe_boost: int = 1):
        """``allowed``: the predicate bitmap over the id space;
        ``nprobe_boost`` multiplies nprobe for this batch (a selective
        filter probes more lists, ``VectorDB._filter_bitmap``)."""
        self._sync()
        q = torch.atleast_2d(torch.as_tensor(q, dtype=torch.float32,
                                             device=self.device))
        metric = self.metric
        if metric == "cosine":
            q = D.l2_normalize(q)
            metric = "dot"
        nprobe = min(self.nprobe * max(1, int(nprobe_boost)),
                     self.centroids.shape[0])
        batch_stats = None if self.scan_all else {}
        out = ivf_pq_search(
            self.codebooks, self.centroids,
            (self.codes_bm, self.bucket_ids, self.block_table), self.corpus,
            q, metric=metric, k=min(k, max(self.size, 1)), nprobe=nprobe,
            refine=self.refine, corpus_sq=self.corpus_sq,
            steps_per_probe=self.spp, lut_dtype=self.lut_dtype,
            adc_mode=self.adc_mode, qblk=self.qblk,
            adaptive_nprobe=self.adaptive_nprobe, adc_stats=batch_stats,
            sched_cache=self.sched_cache,
            sched_key=self._sched_ctx + (nprobe,), scan_all=self.scan_all,
            codes=self.codes, assign=self.assign, valid=self.valid,
            allowed=allowed)
        if batch_stats:
            st = self.adc_stats
            st[batch_stats["mode"]] += 1
            st["probes"] += bool(batch_stats.get("probe"))
            if batch_stats.get("crossover") is not None:
                st["crossover"] = batch_stats["crossover"]
            st["sharing_sum"] += batch_stats["sharing"]
            st["eff_nprobe_sum"] += batch_stats["eff_nprobe"]
            st["batches"] += 1
        return out

    def memory_bytes(self, include_raw: bool = False) -> int:
        """Index-resident bytes, as the reference counts them: the block
        layout (codes, slot ids, block table), codebooks and centroids, the
        row-major codes and assignments under scan_all, |c|^2 for l2 (and
        the re-rank corpus with ``include_raw``)."""
        total = (self.layout.memory_bytes() + self.codebooks.numel() * 4
                 + self.centroids.numel() * 4)
        if self.codes is not None:
            total += self.codes.numel()
        if self.assign is not None:
            total += self.assign.numel() * 4
        if self._sq is not None:
            total += self._sq.data.numel() * 4
        if include_raw and self._corpus is not None:
            total += self._corpus.data.numel() * 4
        return int(total)

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
