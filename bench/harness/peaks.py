"""Peaks of one NVIDIA H100 SXM and the least-time formulas the rooflines
divide by. Frozen here, with their sources, so that no change to the
program moves them.

Published (NVIDIA H100 data sheet, SXM part, dense, at 700 W): HBM3 at
3.35 TB/s, 67 TFLOP/s float32 outside the tensor cores, 495 TFLOP/s TF32
and 989 TFLOP/s bf16 on the tensor cores.

Derived, not published: the shared-memory lookup rate that bounds an ADC
scan, ``LOOKUPS_PER_CLOCK_PER_SM`` 32-bit words a clock an SM (32 banks)
times the SM count times the top SM clock that nvidia-smi reports; copied
from ``chip_smoke.py`` (``LOOKUPS_PER_CLOCK_PER_SM``, ``phase_header``,
``adc_bound``). Every share it bounds says so beside it.
"""
from __future__ import annotations

import torch

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
TF32_OPS_PER_S = 495e12
BF16_OPS_PER_S = 989e12
LOOKUPS_PER_CLOCK_PER_SM = 32


def lookup_rate(sms: int, top_clock_mhz: float) -> float:
    """Derived shared-memory lookups a second of the card."""
    return LOOKUPS_PER_CLOCK_PER_SM * sms * top_clock_mhz * 1e6


def topk_distance_bound(N: int, d: int, Q: int, k: int, bf16: bool) -> float:
    """Least seconds of one exact top-k call (``chip_smoke.topk_bound``):
    the corpus, the row bias and q read once and the (Q, k) result written
    once, against 2 Q N d products; float32 at the lesser of 3xTF32 on the
    tensor cores (the kernel's route) and float32 FMAs, bf16 on the tensor
    cores."""
    esize = 2 if bf16 else 4
    n_bytes = N * d * esize + N * 4 + Q * d * esize + Q * k * 8
    ops = 2.0 * Q * N * d
    t_ops = (ops / BF16_OPS_PER_S if bf16 else
             min(3 * ops / TF32_OPS_PER_S, ops / FP32_OPS_PER_S))
    return max(n_bytes / HBM_BYTES_PER_S, t_ops)


def ivf_adc_work(probes, list_rows, *, m: int, ksub: int, R: int) -> tuple:
    """(bytes, lookups) one IVF-ADC call needs, whatever grid runs it.
    ``probes`` (Q, nprobe) lists each query probes, ``list_rows`` (C,) live
    rows of each list. Bytes: the codes and row ids of each distinct probed
    list read once, the (Q, m, ksub) float32 tables and (Q, nprobe) coarse
    terms read once, the (Q, R) result written once. Lookups: one per
    probed row and subspace per query."""
    Q, nprobe = probes.shape
    distinct = torch.unique(probes)
    rows_read = int(list_rows[distinct].sum())
    scored = int(list_rows[probes].sum())
    n_bytes = (rows_read * (m + 4) + Q * m * ksub * 4 + Q * nprobe * 8
               + Q * R * 8)
    return float(n_bytes), float(scored) * m


def adc_bound(n_bytes: float, lookups: float, lookups_per_s: float) -> float:
    """Least seconds of ADC work: bytes at the HBM rate against lookups at
    the derived rate, the larger."""
    return max(n_bytes / HBM_BYTES_PER_S, lookups / lookups_per_s)
