"""Device-side storage and mutation state shared by the engines (port of
``repro.core.mutable``, the part that load and query need).

Insert, delete, upsert and compact come with ROADMAP.md Queue 1, item 5.
Until then the state here is what those will build on: stable ids, a
generation stamp, and the dirty flag that tells an engine to refresh what
its query path reads.
"""
from __future__ import annotations

import torch


def row_capacity(n: int, minimum: int = 8) -> int:
    """Power-of-two capacity bucket for n rows (the shape ladder)."""
    cap = max(int(minimum), 1)
    while cap < n:
        cap *= 2
    return cap


class GrowableRows:
    """Id-indexed rows on the device: ``data`` is the whole buffer, the
    first ``n`` rows are live.

    ``from_array`` adopts the loaded tensor as the buffer, so its capacity
    is n, not the power-of-two bucket the reference allocates. The
    reference rounds up so that its compiled query plans keep their shapes
    while inserts arrive; PyTorch runs eagerly and compiles no plan, and at
    millions of rows the rounded copy would be a second corpus on the card.
    """

    def __init__(self, data: torch.Tensor, n: int):
        self.data = data
        self.n = int(n)

    @classmethod
    def from_array(cls, arr: torch.Tensor) -> "GrowableRows":
        return cls(arr, arr.shape[0])

    @property
    def capacity(self) -> int:
        return self.data.shape[0]


class MutationMixin:
    """State shared by every engine: the generation stamp, the id space,
    and the dirty flag driving the refresh of query-side tensors."""

    def _mut_init(self, n: int = 0) -> None:
        self.generation = 0
        self.next_id = int(n)  # id space is append-only, never reused
        self._dirty = True
