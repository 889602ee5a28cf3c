"""Plain PyTorch oracles of the ported kernels (port of
``repro.kernels.ref``): each is the mathematical definition, written for
clarity not speed. Top-k is a stable descending sort, so between equal
scores the lower position comes first, as ``lax.top_k`` has it in the
reference.
"""
from __future__ import annotations

import torch

from repro_torch.core.distances import topk_scores
from repro_torch.device import strict_fp32

NEG_INF = -1e30


@strict_fp32()
def topk_distance_ref(corpus, q, *, k: int, metric: str = "dot",
                      corpus_sq=None):
    """corpus: (N, d); q: (Q, d) -> (scores (Q, k) f32, ids (Q, k) int32).

    Fused score + top-k oracle; ``metric`` in {dot, l2} (cosine = dot after
    normalization, done by the caller).
    """
    dots = q.float() @ corpus.float().T
    if metric == "l2":
        c_sq = (corpus_sq if corpus_sq is not None
                else torch.sum(torch.square(corpus.float()), -1))
        q_sq = torch.sum(torch.square(q.float()), -1)
        scores = -(q_sq[:, None] - 2.0 * dots + c_sq[None, :])
    else:
        scores = dots
    s, i = topk_scores(scores, k)
    return s, i.to(torch.int32)


def ivf_adc_ref(bucket_codes, bucket_ids, visit, luts, coarse=None, *,
                k: int, steps_per_probe: int = 1):
    """Bucket-probed ADC oracle: the materialize-everything gather path.

    bucket_codes: (B, blk, m) int; bucket_ids: (B, blk) int32 (-1 pad);
    visit: (Q, T) int32 block ids, T = nprobe * steps_per_probe (step t
    serves probe t // steps_per_probe); luts: (Q, m, ksub) shared or
    (Q, nprobe, m, ksub) per-probe f32; coarse: optional (Q, nprobe)
    additive term -> (scores (Q, k), ids (Q, k)) with knocked-out and
    unfilled slots normalized to (-inf, -1).
    """
    Q, T = visit.shape
    B, blk, m = bucket_codes.shape
    nprobe = T // steps_per_probe
    v = visit.long()
    codes = bucket_codes.long()[v]          # (Q, T, blk, m)
    ids = bucket_ids[v]                     # (Q, T, blk)
    if luts.dim() == 3:
        luts = luts[:, None].expand((Q, nprobe) + tuple(luts.shape[1:]))
    luts = torch.repeat_interleave(luts, steps_per_probe, dim=1)  # (Q,T,m,ksub)
    scores = 0
    for j in range(m):
        scores = scores + torch.gather(luts[:, :, j, :], 2, codes[..., j])
    if coarse is not None:
        scores = scores + torch.repeat_interleave(
            coarse, steps_per_probe, dim=1)[:, :, None]
    scores = torch.where(ids >= 0, scores, NEG_INF)
    flat_s = scores.reshape(Q, T * blk)
    flat_i = ids.reshape(Q, T * blk)
    s, pos = topk_scores(flat_s, min(k, T * blk))
    i = torch.gather(flat_i, 1, pos)
    if s.shape[-1] < k:
        pad = k - s.shape[-1]
        s = torch.nn.functional.pad(s, (0, pad), value=NEG_INF)
        i = torch.nn.functional.pad(i, (0, pad), value=-1)
    bad = s <= 0.5 * NEG_INF
    return (torch.where(bad, -torch.inf, s),
            torch.where(bad, -1, i).to(torch.int32))
