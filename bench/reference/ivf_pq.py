"""Plain reference of the IVF-PQ engine (``VectorDB("ivf_pq")``, cosine), in
float64.

Its semantics, for a unit query q: score every coarse centroid by q . c,
probe the ``nprobe`` best lists, score each row r of them by ADC, q . c
plus the sum over the m subspaces of q_j . codebook_j[code_j(r)], take
the ``refine`` best, and return the k of those with the largest exact
cosine.

``train`` works the trained state out again from the corpus: the engine's
start (a generator on the corpus's device seeded with the configuration's
``seed``: the first ``n_clusters`` rows of one permutation start the coarse
k-means, the first ``ksub`` of one more permutation a subspace its
codebook), then ``kmeans_iters`` Lloyd steps each, in float64.
``train_numbers`` holds the program's centroids and codebooks to it, by
the distance between a program's centroid or codeword and the
reference's of the same index.
From there the reference follows the program's state: it checks by itself
that each row sits, once, in the list of its nearest centroid
(``assign_gap``) and that its code is the nearest codeword of each
subspace of its residual (``code_gap``), both as the largest shortfall
below the best, and judges the answers against the engine's semantics over
that state. Where rounding could tip a choice (two lists or two ADC scores
within ``TIE`` of the cut), every choice is admissible, and an answer is
judged against the admissible choice that suits it best.

``control`` is this reference in bf16 in the program's place: its own
training, assignment, codes, probes, tables and re-rank, with every row,
centroid, codeword and product in bf16 (a Lloyd step's sums in float32).
"""
from __future__ import annotations

import itertools

import numpy as np
import torch

from reference.common import (EMPTY_GAP, answer_numbers, exact_scores,
                              rank_gap, unit64)

# the leaves of the engine's own snapshot (``state_dict``) it follows
STATE = ("centroids", "codebooks", "codes", "buckets")
# Scores within TIE of a cut may fall either side of it in float32: the
# bound on a 768-term float32 dot of unit vectors, 2 d 2^-24 = 9.2e-5,
# rounded up.
TIE = 1e-4
MAX_CHOICES = 16  # admissible choices tried at one cut
ROWS = 1 << 15    # rows a block of the stage checks


def _lists(buckets):
    """(flat row ids, starts, counts) of each list's rows, list by list."""
    valid = buckets >= 0
    counts = valid.sum(dim=1)
    flat = buckets[valid].long()
    starts = torch.cumsum(counts, 0) - counts
    return flat, starts.cpu().numpy(), counts.cpu().numpy()


def row_lists(buckets, n: int):
    """(n,) list of each row (-1 if in none) and (n,) times it appears."""
    flat, starts, counts = _lists(buckets)
    which = torch.repeat_interleave(
        torch.arange(buckets.shape[0], device=buckets.device),
        torch.as_tensor(counts, device=buckets.device))
    seen = torch.bincount(flat, minlength=n)[:n]
    lists = torch.full((n,), -1, dtype=torch.int64, device=buckets.device)
    lists[flat] = which
    return lists, seen


def _split(x, m: int):
    return x.reshape(x.shape[0], m, -1)


def stage_numbers(corpus, state) -> dict:
    """``assign_gap``, ``code_gap`` and ``bad_rows`` (rows in no list or
    in two) of the state's assignment and codes."""
    n = corpus.shape[0]
    cent = state["centroids"].double()
    cb = state["codebooks"].double()
    m = cb.shape[0]
    c_sq = (cent * cent).sum(dim=1)
    cb_sq = (cb * cb).sum(dim=2)                                  # (m, ksub)
    lists, seen = row_lists(state["buckets"], n)
    a_gap = c_gap = 0.0
    for a in range(0, n, ROWS):
        x = unit64(corpus[a:a + ROWS])
        li = lists[a:a + ROWS].clamp(min=0)
        s = 2.0 * x @ cent.T - c_sq
        a_gap = max(a_gap, float((s.max(dim=1).values
                                  - s.gather(1, li[:, None])[:, 0]).max()))
        r = _split(x - cent[li], m)
        t = 2.0 * torch.einsum("nmd,mkd->nmk", r, cb) - cb_sq
        code = state["codes"][a:a + ROWS].long()
        c_gap = max(c_gap, float((t.max(dim=2).values
                                  - t.gather(2, code[:, :, None])[:, :, 0]
                                  ).max()))
    return {"assign_gap": a_gap, "code_gap": c_gap,
            "bad_rows": int((seen != 1).sum())}


def _rows(corpus, a: int, dtype):
    return unit64(corpus[a:a + ROWS]).to(dtype)


def _nearest(x, cent):
    """(B,) nearest centroid of each row of x: argmax of 2 x.c - |c|^2,
    ties to the lower index, in x's precision."""
    c_sq = (cent * cent).sum(dim=1)
    return torch.argmax(torch.addmm(-c_sq, x, cent.T, alpha=2.0), dim=1)


def _codes(r, cb):
    """(B, m) nearest codeword of each subspace of the residuals r
    (B, m, dsub), the rule of ``_nearest``."""
    t = torch.einsum("nmd,mkd->nmk", r, cb)
    return torch.argmax(t.mul_(2.0).sub_((cb * cb).sum(dim=2)), dim=2)


def _means(sums, counts, old):
    """Lloyd's update: each mean, and the old value where none was
    assigned."""
    new = sums / counts.clamp(min=1)[:, None]
    return torch.where((counts > 0)[:, None], new, old)


def train(corpus, cfg: dict, dtype=torch.float64) -> dict:
    """The engine's training worked out again (the module docstring), every
    row, centroid, codeword and product in ``dtype``; the sums of a
    Lloyd step in float64 for float64 and in float32 below it.
    {"centroids" (C, d), "codebooks" (m, ksub, dsub), "assign" (n,),
    "coarse_err" (``coarse_err``)}."""
    args = cfg["engine_args"]
    n, d = corpus.shape
    C, m = int(args["n_clusters"]), int(args["m"])
    ksub, iters = min(int(args["ksub"]), n), int(args["kmeans_iters"])
    if d % m:
        raise ValueError(f"d = {d} is no multiple of m = {m}")
    acc = torch.float64 if dtype == torch.float64 else torch.float32
    dev = corpus.device
    gen = torch.Generator(device=dev).manual_seed(int(args["seed"]))
    first = torch.randperm(n, generator=gen, device=dev)[:C]
    cent = unit64(corpus[first]).to(acc)
    for _ in range(iters):
        sums = torch.zeros_like(cent)
        counts = torch.zeros(C, dtype=acc, device=dev)
        c = cent.to(dtype)
        for a in range(0, n, ROWS):
            x = _rows(corpus, a, dtype)
            li = _nearest(x, c)
            sums.index_add_(0, li, x.to(acc))
            counts.index_add_(0, li, torch.ones_like(li, dtype=acc))
        cent = _means(sums, counts, cent)
    cent = cent / torch.linalg.vector_norm(cent, dim=1, keepdim=True)
    c = cent.to(dtype)
    assign = torch.cat([_nearest(_rows(corpus, a, dtype), c)
                        for a in range(0, n, ROWS)])
    err = coarse_err(corpus, cent, assign)

    first = torch.stack([torch.randperm(n, generator=gen, device=dev)[:ksub]
                         for _ in range(m)]).reshape(-1)      # (m * ksub,)
    r = _split(unit64(corpus[first]).to(dtype) - c[assign[first]], m)
    ar = torch.arange(m, device=dev)
    cb = r.reshape(m, ksub, m, -1)[ar, :, ar].to(acc)         # (m, ksub, dsub)
    dsub = cb.shape[2]
    offs = (ar * ksub)[None, :]
    for _ in range(iters):
        sums = torch.zeros((m * ksub, dsub), dtype=acc, device=dev)
        counts = torch.zeros(m * ksub, dtype=acc, device=dev)
        b = cb.to(dtype)
        for a in range(0, n, ROWS):
            r = _split(_rows(corpus, a, dtype) - c[assign[a:a + ROWS]], m)
            idx = (_codes(r, b) + offs).reshape(-1)
            sums.index_add_(0, idx, r.reshape(-1, dsub).to(acc))
            counts.index_add_(0, idx, torch.ones_like(idx, dtype=acc))
        cb = _means(sums, counts, cb.reshape(-1, dsub)).reshape(m, ksub, dsub)
    return {"centroids": cent, "codebooks": cb, "assign": assign,
            "coarse_err": err}


def coarse_err(corpus, cent, assign) -> float:
    """Mean squared distance, in float64, of a unit row to the centroid of
    its list ``assign``."""
    cent = cent.double()
    total = 0.0
    for a in range(0, corpus.shape[0], ROWS):
        d = unit64(corpus[a:a + ROWS]) - cent[assign[a:a + ROWS]]
        total += float((d * d).sum())
    return total / corpus.shape[0]


def prepare(corpus, cfg: dict) -> dict:
    """What the reference derives once and ``judge`` and ``control`` use:
    its own trained state, in float64."""
    return train(corpus, cfg)


def train_numbers(state, own) -> dict:
    """A state's centroids and codebooks against the reference's own
    training ``own``, a gap being the distance between the two vectors of
    one index: the largest centroid's (``centroid_gap``), the median
    codeword's (``codeword_gap_median``), and the relative gap of the
    mean squared distance of a row to its list's centroid
    (``coarse_err_gap``). The largest codeword's gap is no number: a
    codeword that a few rows hold moves with each near-tie that rounding
    tips, and reads alike in sound runs and in the bf16 control."""
    def gaps(x, y):
        return torch.linalg.vector_norm(x.double() - y.double(), dim=-1)
    return {"centroid_gap": float(gaps(state["centroids"],
                                       own["centroids"]).max()),
            "codeword_gap_median": float(gaps(state["codebooks"],
                                              own["codebooks"]).median()),
            "coarse_err_gap": abs(state["coarse_err"] / own["coarse_err"]
                                  - 1.0)}


def _cut(scores: np.ndarray, keep: int):
    """(sure, band) positions at a top-``keep`` cut of ``scores``: sure
    lie above the cut by more than TIE, band within TIE of it."""
    if scores.size <= keep:
        return np.arange(scores.size), np.arange(0)
    t = np.sort(scores)[::-1][keep - 1]
    return (np.nonzero(scores > t + TIE)[0],
            np.nonzero(np.abs(scores - t) <= TIE)[0])


def _choices(sure, band, keep: int):
    need = keep - sure.size
    for pick in itertools.islice(itertools.combinations(band, need),
                                 MAX_CHOICES):
        yield np.concatenate([sure, np.asarray(pick, dtype=np.int64)])


class _Engine:
    """The float64 semantics over one state, a query at a time."""

    def __init__(self, corpus, state, cfg):
        args = cfg["engine_args"]
        self.nprobe, self.refine = int(args["nprobe"]), int(args["refine"])
        self.corpus = corpus
        self.cent = state["centroids"].double()
        self.cb = state["codebooks"].double()
        self.codes = state["codes"]
        self.flat, self.starts, self.counts = _lists(state["buckets"])
        self.dev = corpus.device

    def rows_of(self, lists):
        idx = np.concatenate([np.arange(self.starts[c],
                                        self.starts[c] + self.counts[c])
                              for c in lists]) if len(lists) else np.arange(0)
        which = np.repeat(np.asarray(lists), self.counts[lists])
        return (self.flat[torch.as_tensor(idx, device=self.dev)],
                torch.as_tensor(which, device=self.dev))

    def rows_at(self, rows, pos: np.ndarray):
        return rows[torch.as_tensor(pos, dtype=torch.int64, device=self.dev)]

    def adc(self, q64, coarse, rows, which):
        m = self.cb.shape[0]
        lut = torch.einsum("md,mkd->mk", q64.reshape(m, -1), self.cb)
        codes = self.codes[rows].long()                           # (R, m)
        terms = lut[torch.arange(m, device=self.dev)[None, :], codes]
        return coarse[which] + terms.sum(dim=1)

    def gap(self, q64, coarse, ids, got):
        """Smallest rank gap between ``got`` (k,), the exact scores of the
        answered rows ``ids`` (k,) best first, and the engine's answer over
        the admissible choices: each admissible set of probed lists, and at
        the refine cut the rows above it, the answered rows within TIE of
        it, and the other rows within TIE of lowest exact score to fill it
        (the choice most favourable to the answer)."""
        k = got.numel()
        best = EMPTY_GAP
        c_np = coarse.cpu().numpy()
        sure, band = _cut(c_np, self.nprobe)
        for lists in _choices(sure, band, min(self.nprobe, c_np.size)):
            rows, which = self.rows_of(lists)
            a_np = self.adc(q64, coarse, rows, which).cpu().numpy()
            keep = min(self.refine, a_np.size)
            s2, b2 = _cut(a_np, keep)
            at = self.rows_at
            mine = np.isin(at(rows, b2).cpu().numpy(), ids.cpu().numpy())
            need = keep - s2.size - int(mine.sum())
            if need < 0:
                continue
            rest = b2[~mine]
            if rest.size and need:
                ex = exact_scores(self.corpus, q64[None],
                                  at(rows, rest)[None])[0]
                rest = rest[torch.argsort(ex).cpu().numpy()[:need]]
            else:
                rest = rest[:0]
            cand = np.concatenate([s2, b2[mine], rest])
            ref = exact_scores(self.corpus, q64[None],
                               at(rows, cand)[None])[0]
            ref = torch.sort(ref, descending=True).values[:k]
            ref = torch.cat([ref, torch.full((k - ref.numel(),), -torch.inf,
                                             dtype=ref.dtype,
                                             device=ref.device)])
            best = min(best, float(rank_gap(ref[None], got[None])[0]))
            if best == 0.0:
                break
        return best


def judge(corpus, queries, scores, ids, missing, cfg: dict, state, own):
    """The training numbers of ``state`` against ``own`` (``prepare``), its
    stage numbers, and the numbers of ``reference.common``; each answer is
    held to the admissible answer nearest it."""
    lists, _ = row_lists(state["buckets"], corpus.shape[0])
    state = dict(state, coarse_err=coarse_err(corpus, state["centroids"],
                                              lists.clamp(min=0)))
    numbers = train_numbers(state, own)
    numbers.update(stage_numbers(corpus, state))
    eng = _Engine(corpus, state, cfg)
    q64 = unit64(queries)
    coarse = q64 @ eng.cent.T

    def gap_of(got):
        return torch.tensor([eng.gap(q64[i], coarse[i], ids[i], got[i])
                             for i in range(ids.shape[0])],
                            dtype=torch.float64, device=got.device)

    numbers.update(answer_numbers(corpus, q64, scores, ids, missing, gap_of))
    return numbers


# ----------------------------------------------------------------- control
def _encode(corpus, cent, cb, assign):
    """Codes of every row under its list ``assign``, in the precision of
    ``cent`` and ``cb``."""
    m = cb.shape[0]
    codes = torch.empty((corpus.shape[0], m), dtype=torch.uint8,
                        device=corpus.device)
    for a in range(0, corpus.shape[0], ROWS):
        r = _split(_rows(corpus, a, cent.dtype) - cent[assign[a:a + ROWS]], m)
        codes[a:a + ROWS] = _codes(r, cb).to(torch.uint8)
    return codes


def _buckets(assign, C: int):
    counts = torch.bincount(assign, minlength=C)
    order = torch.sort(assign, stable=True).indices
    first = torch.cumsum(counts, 0) - counts
    a_sorted = assign[order]
    rank = torch.arange(assign.shape[0], device=assign.device) - first[a_sorted]
    out = torch.full((C, int(counts.max())), -1, dtype=torch.int64,
                     device=assign.device)
    out[a_sorted, rank] = order
    return out


def control(corpus, queries, k: int, cfg: dict, state, own):
    """This reference in bf16 in the program's place: (scores, ids, the
    state it trained and encoded) for the queries."""
    args = cfg["engine_args"]
    nprobe, refine = int(args["nprobe"]), int(args["refine"])
    mine = train(corpus, cfg, torch.bfloat16)
    cent16 = mine["centroids"].bfloat16()
    cb16 = mine["codebooks"].bfloat16()
    m = cb16.shape[0]
    codes = _encode(corpus, cent16, cb16, mine["assign"])
    own16 = {"centroids": mine["centroids"], "codebooks": mine["codebooks"],
             "codes": codes,
             "buckets": _buckets(mine["assign"], cent16.shape[0])}
    flat, starts, counts = _lists(own16["buckets"])
    S = queries.shape[0]
    out_s = torch.full((S, k), -torch.inf, device=queries.device)
    out_i = torch.full((S, k), -1, dtype=torch.int64, device=queries.device)
    for i in range(S):
        q = unit64(queries[i:i + 1])[0].bfloat16()
        coarse = cent16 @ q
        lists = torch.topk(coarse, nprobe).indices.cpu().numpy()
        idx = np.concatenate([np.arange(starts[c], starts[c] + counts[c])
                              for c in lists])
        rows = flat[torch.as_tensor(idx, device=q.device)]
        which = torch.as_tensor(np.repeat(lists, counts[lists]),
                                device=q.device)
        lut = torch.einsum("md,mkd->mk", q.reshape(m, -1), cb16)
        terms = lut[torch.arange(m, device=q.device)[None, :],
                    codes[rows].long()]
        adc = coarse[which] + terms.sum(dim=1)
        cand = rows[torch.topk(adc, min(refine, adc.numel())).indices]
        ex = unit64(corpus[cand]).bfloat16() @ q
        s, pos = torch.topk(ex, min(k, ex.numel()))
        out_s[i, :s.numel()] = s.float()
        out_i[i, :s.numel()] = cand[pos]
    return out_s, out_i, own16
