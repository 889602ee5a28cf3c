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


def l2_normalize(x: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return x / torch.clamp(norm, min=eps)


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


def mask_invalid_ids(scores, ids):
    """Normalize knocked-out top-k slots (-inf scores) to id -1."""
    return scores, torch.where(torch.isneginf(scores), -1, ids)


def merge_topk(scores_a, idx_a, scores_b, idx_b, k: int):
    """Merge two (Q, ka/kb) candidate sets into the global top-k; between
    equal scores set a comes first."""
    s, pos = topk_scores(torch.cat([scores_a, scores_b], dim=-1), k)
    return s, torch.gather(torch.cat([idx_a, idx_b], dim=-1), 1, pos)
