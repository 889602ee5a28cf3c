"""What a driver records of a window, and the copy of a call's results to
the host.

A query's latency runs from the moment it is handed to the entry to its
result on the host. Queries handed over inside the window are attempted;
those whose results reach the host inside it are completed in the window.
The answers of some of them, drawn from the seed, are kept for the
reference to judge.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch


@dataclass
class Record:
    t_start: float = 0.0
    t_end: float = 0.0
    attempted: int = 0
    failed: int = 0
    completed_in_window: int = 0
    latencies_ms: list = field(default_factory=list)   # (ms, queries, t_done)
    kept: list = field(default_factory=list)   # (pool row, scores, ids | None)
    calls: list = field(default_factory=list)  # first pool row of each call

    def latency_array(self) -> np.ndarray:
        if not self.latencies_ms:
            return np.zeros(0)
        ms, n, _ = zip(*self.latencies_ms)
        return np.repeat(np.asarray(ms), np.asarray(n))

    def rates(self, step: float) -> list:
        """Queries a second completed in each ``step`` seconds of the
        window, in order: whether the rate drifts inside a run."""
        out = [0] * max(1, round((self.t_end - self.t_start) / step))
        for _, n, t in self.latencies_ms:
            j = int((t - self.t_start) // step)
            if 0 <= j < len(out):
                out[j] += n
        return [round(c / step) for c in out]


def to_host(scores, ids):
    """Start the copy of a call's results to the host: (host tensor, event),
    or the results themselves and None off the card."""
    packed = torch.stack([scores.float(), ids.to(torch.int32).view(
        torch.float32)])
    if not packed.is_cuda:
        return packed, None
    host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
    host.copy_(packed, non_blocking=True)
    ev = torch.cuda.Event()
    ev.record()
    return host, ev


def unpack(host):
    return host[0].numpy(), host[1].view(torch.int32).numpy()
