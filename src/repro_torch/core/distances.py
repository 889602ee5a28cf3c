"""Distance / similarity scoring for the vector DB (port of
``repro.core.distances``).

All engines rank by a SCORE where higher = closer, so one top-k path serves
every metric:
  * dot    : q . c
  * cosine : normalized dot
  * l2     : -(|q|^2 - 2 q.c + |c|^2)  (negative squared Euclidean)

Top-k here is a stable descending sort, so equal scores keep the lower
position first: the order ``lax.top_k`` gives the reference. ``torch.topk``
does not state an order for ties, and the port does not use it.
"""
from __future__ import annotations

import torch

from repro_torch.device import strict_fp32

METRICS = ("dot", "cosine", "l2")
KERNEL_WIDTH = 8  # topk_distance takes d a multiple of 8 (16-byte bf16 rows)


def l2_normalize(x: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return x / torch.clamp(norm, min=eps)


def pad_width(x: torch.Tensor) -> torch.Tensor:
    """x (..., d) with zero columns appended up to the next multiple of
    ``KERNEL_WIDTH``, the width the ``topk_distance`` kernel takes; x
    itself when d is one. Zero columns change no dot, l2 or cosine score
    (nor a norm), so an engine pads its scan buffer once at load and
    write, and each query batch."""
    pad = (-x.shape[-1]) % KERNEL_WIDTH
    if pad == 0:
        return x
    return torch.cat([x, x.new_zeros(x.shape[:-1] + (pad,))], dim=-1)


def preprocess_corpus(corpus: torch.Tensor, metric: str):
    """Metric-specific corpus precompute done once at load time.

    Returns (corpus, side_info): cosine pre-normalizes; l2 caches |c|^2.
    """
    if metric == "cosine":
        return l2_normalize(corpus), None
    if metric == "l2":
        return corpus, torch.sum(torch.square(corpus.float()), dim=-1)
    return corpus, None


@strict_fp32()
def pairwise_scores(q, corpus, metric: str, corpus_sq=None):
    """q: (Q, d); corpus: (N, d) -> scores (Q, N) f32, higher = closer."""
    if metric == "cosine":
        q = l2_normalize(q)
    dots = q.float() @ corpus.float().T
    if metric in ("dot", "cosine"):
        return dots
    if corpus_sq is None:
        corpus_sq = torch.sum(torch.square(corpus.float()), dim=-1)
    q_sq = torch.sum(torch.square(q.float()), dim=-1)
    return -(q_sq[:, None] - 2.0 * dots + corpus_sq[None, :])


def topk_scores(scores: torch.Tensor, k: int):
    """(Q, N) -> (top scores (Q, k), positions (Q, k) int64), best first,
    ties to the lower position."""
    s, pos = torch.sort(scores, dim=-1, descending=True, stable=True)
    return s[:, :k], pos[:, :k]


@strict_fp32()
def score_rows(corpus, corpus_sq, ids, q, metric: str):
    """Exact scores of the candidate rows ``ids`` (Q, L) for q (Q, d), in
    float32 (bf16 rows: products of the bf16 values summed in float32);
    metric dot or l2 (cosine = dot on normalized rows). Id -1 is a pad and
    scores -inf. ``corpus_sq`` (|c|^2, l2 only) is recomputed from the
    rows when None."""
    valid = ids >= 0
    safe = ids.clamp(min=0).long()
    vecs = corpus[safe].float()                                 # (Q, L, d)
    qf = q.float()
    dots = torch.einsum("qd,qld->ql", qf, vecs)
    if metric == "dot":
        scores = dots
    else:
        sq = (corpus_sq[safe] if corpus_sq is not None
              else torch.sum(torch.square(vecs), -1))
        scores = -(torch.sum(torch.square(qf), -1)[:, None] - 2.0 * dots + sq)
    return torch.where(valid, scores, -torch.inf)


def rerank_topk(corpus, corpus_sq, ids, q, *, metric: str, k: int):
    """Exact top-k over the candidate rows ``ids`` (Q, L) (-1 = pad):
    (scores (Q, k), ids (Q, k)), best first, ties to the lower candidate
    position; slots past the live candidates are (-inf, -1)."""
    scores = score_rows(corpus, corpus_sq, ids, q, metric)
    s, pos = topk_scores(scores, min(k, ids.shape[1]))
    return pad_to_k(*mask_invalid_ids(s, torch.gather(ids, 1, pos)), k)


def pad_to_k(scores, ids, k: int):
    """Pad (Q, kk) top-k results to k columns with (-inf, -1)."""
    kk = scores.shape[-1]
    if kk < k:
        scores = torch.nn.functional.pad(scores, (0, k - kk),
                                         value=-torch.inf)
        ids = torch.nn.functional.pad(ids, (0, k - kk), value=-1)
    return scores, ids


def mask_invalid_ids(scores, ids):
    """Normalize knocked-out top-k slots (-inf scores) to id -1."""
    return scores, torch.where(torch.isneginf(scores), -1, ids)


def merge_topk(scores_a, idx_a, scores_b, idx_b, k: int):
    """Merge two (Q, ka/kb) candidate sets into the global top-k; between
    equal scores set a comes first."""
    s, pos = topk_scores(torch.cat([scores_a, scores_b], dim=-1), k)
    return s, torch.gather(torch.cat([idx_a, idx_b], dim=-1), 1, pos)
