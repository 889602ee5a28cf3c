"""What the plain references share: exact cosine scores in float64 and the
numbers an answer is judged by. Plain PyTorch; imports nothing of the
program.

An answer is a row of (scores (k,), ids (k,)) as the program returned it
for one query, ids -1 where it returned none. Judged against the true
answer of the engine's semantics, computed here in float64:

* ``answer_gap``: the largest difference, rank by rank, between the exact
  score of the program's row and the exact score of the reference's row
  (2, the widest gap two cosines can have, where only one side has a row).
  Rows that tie to within rounding may swap places and read about 1e-7;
  a wrong row reads its distance from the right one.
* ``score_err``: the largest difference between a score the program
  returned and the exact score of the row it named.
* ``bad_answers``: answers with an id out of range or repeated, or that
  never came.
"""
from __future__ import annotations

import torch

EMPTY_GAP = 2.0   # cosines lie in [-1, 1]


def unit64(x):
    x = x.double()
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def exact_scores(corpus, q64, ids):
    """(S, k) float64 cosines of rows ``ids`` (S, k) for q64 (S, d); -inf
    where an id is out of range."""
    n = corpus.shape[0]
    ok = (ids >= 0) & (ids < n)
    rows = unit64(corpus[ids.clamp(0, n - 1).long()])
    s = torch.einsum("sd,skd->sk", q64, rows)
    return torch.where(ok, s, -torch.inf)


def bad_rows(ids, n: int) -> torch.Tensor:
    """(S,) True where an answer names an id out of range (other than the
    -1 of an empty slot after the filled ones) or one id twice."""
    ids = ids.long()
    filled = ids >= 0
    out = (ids >= n).any(dim=1)
    # an empty slot before a filled one is no answer the engine gives
    out |= (~filled[:, :-1] & filled[:, 1:]).any(dim=1)
    srt = torch.sort(torch.where(filled, ids, -1 - torch.arange(
        ids.shape[1], device=ids.device)), dim=1).values
    out |= (srt[:, 1:] == srt[:, :-1]).any(dim=1)
    return out


def rank_gap(ref, got):
    """(S,) largest |ref - got| over ranks of two (S, k) float64 score
    tables, best first; -inf on both sides is no gap, on one side
    EMPTY_GAP."""
    both = torch.isneginf(ref) & torch.isneginf(got)
    one = torch.isneginf(ref) ^ torch.isneginf(got)
    gap = (ref - got).abs()
    gap = torch.where(both, 0.0, torch.where(one, EMPTY_GAP, gap))
    return gap.max(dim=1).values


def answer_numbers(corpus, q64, scores, ids, missing, gap_of):
    """The three numbers of the module docstring for answers (scores, ids)
    (S, k). ``gap_of(got)`` gives the (S,) rank gaps of the exact scores
    ``got`` (S, k) of the answered rows, best first; ``missing`` (S,)
    marks answers that never came."""
    n = corpus.shape[0]
    got = exact_scores(corpus, q64, ids)
    got = torch.where(ids >= 0, got, -torch.inf)
    bad = bad_rows(ids, n) | missing
    gap = gap_of(torch.sort(got, dim=1, descending=True).values)
    gap = torch.where(bad, EMPTY_GAP, gap)
    filled = ids >= 0
    err = torch.nan_to_num((scores.double() - got).abs(), nan=EMPTY_GAP)
    err = torch.where(filled, err, 0.0).max(dim=1).values
    err = torch.where(bad, EMPTY_GAP, err)
    return {"answer_gap": float(gap.max()), "score_err": float(err.max()),
            "bad_answers": int(bad.sum())}
