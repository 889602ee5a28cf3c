"""Public wrappers around the port's kernels (port of
``repro.kernels.ops``, the parts the exact and IVF-PQ engines use).

Each wrapper prepares the kernel's inputs and dispatches on the tensor's
device (``repro_torch.device.kernel_path``): a CUDA tensor launches the
hand-written kernel, a CPU tensor runs its plain PyTorch version.
``use_kernel=True`` forces the kernel (and raises on a CPU tensor);
``use_kernel=False`` forces the plain version, which only the
kernel-against-plain comparisons use.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ivf_adc as _ivf
from repro_torch.kernels import topk_distance as _tk
from repro_torch.kernels.topk_distance import NEG_INF

ADC_LUT_DTYPES = _ivf.LUT_DTYPES
ADC_MODES = ("auto", "blocked", "per_query", "run_resident")
LAUNCH_COUNTERS = (_tk.LAUNCHES, _ivf.LAUNCHES)


def launch_counts() -> dict:
    """{kernel name: launches since the last reset}."""
    return {c.name: c.n for c in LAUNCH_COUNTERS}


def reset_launch_counts() -> None:
    for c in LAUNCH_COUNTERS:
        c.reset()


def normalize_knockouts(s, i):
    """Anything at or below NEG_INF/2 (a knocked-out or unfilled slot) ->
    (-inf, -1); real scores live many orders of magnitude above."""
    bad = s <= 0.5 * NEG_INF
    return torch.where(bad, -torch.inf, s), torch.where(bad, -1, i)


def topk_distance(corpus, q, *, k: int, metric: str = "dot", corpus_sq=None,
                  valid=None, use_kernel=None):
    """Fused exact top-k. corpus: (N, d); q: (Q, d); metric in {dot, l2}.

    Rows where ``valid`` is False are knocked out through the additive
    score bias (-1e30), as in the reference. Returns (scores (Q, k) f32,
    ids (Q, k) int32) as the kernel leaves them: a knocked-out row can
    still appear, near -1e30, when fewer than k rows are live.
    """
    N = corpus.shape[0]
    l2 = metric == "l2"
    if l2:
        if corpus_sq is None:
            corpus_sq = torch.sum(torch.square(corpus.float()), dim=-1)
        bias = -corpus_sq.float()
    else:
        bias = torch.zeros((N,), dtype=torch.float32, device=corpus.device)
    if valid is not None:
        bias = torch.where(valid, bias, NEG_INF)
    s, i = _tk.topk_distance(corpus, q.float(), bias, k=k, l2=l2,
                             use_kernel=use_kernel)
    if l2:
        s = s - torch.sum(torch.square(q.float()), dim=-1, keepdim=True)
    return s, i


def ivf_adc_topk(bucket_codes, bucket_ids, visit, luts, *, k: int,
                 coarse=None, steps_per_probe: int = 1, use_kernel=None,
                 lut_dtype: str = "float32", mode: str = "per_query"):
    """Bucket-resident IVF-ADC top-k, the IVF-PQ hot path. Work scales
    with the probed candidate count, not N.

    bucket_codes: (B, blk, m) uint8 codes in the block-aligned bucket-major
    layout (row b of ``bucket_ids`` names the global row each slot holds,
    -1 = pad; see ``repro_torch.core.ivf.BlockListLayout``); visit: (Q, T)
    int32 block ids with T = nprobe * steps_per_probe; luts: (Q, m, ksub)
    shared tables (dot) or (Q, nprobe, m, ksub) per-probe tables (l2);
    ``coarse``: optional (Q, nprobe) f32 additive per-probe term, also a
    probe knockout when an entry is NEG_INF.

    Only the per-query grid is ported; the grouped grids give the same
    results (invariant 5 of docs/ARCHITECTURE.md) and come with
    ROADMAP.md Queue 1, item 3. Returns (scores (Q, k) f32, ids (Q, k)
    int32) with knocked-out and unfilled slots as (-inf, -1).
    """
    if lut_dtype not in ADC_LUT_DTYPES:
        raise ValueError(f"lut_dtype {lut_dtype!r} not in {ADC_LUT_DTYPES}")
    if mode not in ADC_MODES:
        raise ValueError(f"mode {mode!r} not in {ADC_MODES}")
    if mode != "per_query":
        raise NotImplementedError(
            f"adc_mode={mode!r}: the grouped IVF-ADC grids are not ported "
            "yet (ROADMAP.md Queue 1, item 3); use mode='per_query'")
    Q, T = visit.shape
    if coarse is None:
        coarse = torch.zeros((Q, T // steps_per_probe), dtype=torch.float32,
                             device=visit.device)
    s, i = _ivf.ivf_adc(bucket_codes, bucket_ids, visit, luts, coarse, k=k,
                        steps_per_probe=steps_per_probe, lut_dtype=lut_dtype,
                        use_kernel=use_kernel)
    return normalize_knockouts(s, i)
