"""Plain reference of the exact engine (``VectorDB("flat")``, cosine): the
k rows of largest cosine over the whole collection, in float64, a block of
rows at a time.

``judge`` holds the program's answers to it; ``control`` is this reference
put in the program's place in bf16 (corpus and queries cast to bf16, the
scores rounded to bf16), the precision below the configuration's float32,
which the comparison has to refuse.
"""
from __future__ import annotations

import torch

from reference.common import answer_numbers, rank_gap, unit64

BLOCK = 1 << 19   # rows a block: float64 rows and scores stay a few GB


def topk(corpus, q, k: int, dtype=torch.float64):
    """(scores (S, k), ids (S, k)) of the k largest cosines of each query
    over ``corpus``, every product and sum in ``dtype``."""
    S = q.shape[0]
    qd = unit64(q).to(dtype)
    best_s = torch.full((S, k), -torch.inf, dtype=dtype, device=q.device)
    best_i = torch.full((S, k), -1, dtype=torch.int64, device=q.device)
    for a in range(0, corpus.shape[0], BLOCK):
        rows = unit64(corpus[a:a + BLOCK]).to(dtype)
        s = qd @ rows.T
        cs, ci = torch.topk(s, min(k, s.shape[1]), dim=1)
        s_all = torch.cat([best_s, cs], dim=1)
        i_all = torch.cat([best_i, ci + a], dim=1)
        best_s, pos = torch.topk(s_all, k, dim=1)
        best_i = torch.gather(i_all, 1, pos)
    return best_s, best_i


def prepare(corpus, cfg: dict):
    """Nothing is derived ahead: the engine trains nothing."""
    return None


def judge(corpus, queries, scores, ids, missing, cfg: dict, state=None,
          own=None):
    """The numbers of ``reference.common`` for the program's answers."""
    k = ids.shape[1]
    ref_s, _ = topk(corpus, queries, k)
    return answer_numbers(corpus, unit64(queries), scores, ids, missing,
                          lambda got: rank_gap(ref_s, got))


def control(corpus, queries, k: int, cfg: dict, state=None, own=None):
    """This reference in bf16 in the program's place: (scores, ids, state)."""
    s, i = topk(corpus, queries, k, dtype=torch.bfloat16)
    return s.float(), i, state
