"""The mutation lifecycle shared by every mutable engine (port of
``repro.core.mutable``): insert / delete / upsert / compact / reserve.

    ids = idx.insert(vectors)            # append rows, returns assigned ids
    n   = idx.delete(ids)                # tombstone rows (ids stay retired)
    ids = idx.upsert(vectors, ids)       # re-encode existing ids in place
    idx.compact()                        # reclaim tombstoned query work
    idx.size                             # LIVE row count
    idx.generation                       # bumps once per mutation batch
    idx.shape_key                        # changes iff a buffer is reallocated

The reference's design rules hold: ids are assigned by a host counter,
never reused or renumbered (deletes tombstone, compaction repacks layout
structures only), and a tombstoned row reads exactly like a pad row
(``-1`` in a slot table, False in a live mask), so no kernel changes.

Two differences. The reference edits host mirrors and uploads them lazily;
here every buffer lives on the engine's device and a write edits it in
place, so a batch of writes costs device work and no transfer of the
corpus. And capacities grow by a bounded geometric step, not by doubling:
at 8.8M rows of d = 768 the float32 re-rank corpus is 27.2 GB, and a
doubled copy beside the old one would need 78.7 GB of an 80 GB card.
"""
from __future__ import annotations

from typing import Protocol, runtime_checkable

import torch

GROWTH_DIVISOR = 8  # a growing buffer adds at least capacity / 8 rows


def row_capacity(n: int, minimum: int = 8) -> int:
    """Power-of-two capacity bucket for n rows (the shape ladder)."""
    cap = max(int(minimum), 1)
    while cap < n:
        cap *= 2
    return cap


@runtime_checkable
class MutableIndex(Protocol):
    """Duck-typed mutation protocol (see the module docstring)."""

    def insert(self, vectors, ids=None) -> torch.Tensor: ...
    def delete(self, ids) -> int: ...
    def upsert(self, vectors, ids) -> torch.Tensor: ...
    def compact(self) -> dict: ...
    @property
    def size(self) -> int: ...


class GrowableRows:
    """Id-indexed rows on the device: ``data`` is the whole buffer, the
    first ``n`` rows are the id space so far, and rows past ``n`` are zero.

    ``from_array`` adopts the loaded tensor as the buffer (capacity n, not
    the reference's power-of-two bucket: PyTorch compiles no plan whose
    shapes a bucket would keep, and at millions of rows the rounded copy
    would be a second corpus on the card). Growth for a write takes the
    larger of what is needed and capacity + capacity / GROWTH_DIVISOR:
    amortized O(1) a row, and the copy beside the old buffer costs at
    most an eighth more than the buffer. ``reserve(n, exact=True)`` grows
    once to exactly n.
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

    def reserve(self, n: int, exact: bool = False) -> bool:
        """Grow the buffer to hold n rows; True when it was reallocated."""
        cap = self.capacity
        if n <= cap:
            return False
        new_cap = n if exact else max(n, cap + cap // GROWTH_DIVISOR)
        grown = torch.empty((new_cap,) + tuple(self.data.shape[1:]),
                            dtype=self.data.dtype, device=self.data.device)
        grown[: self.n] = self.data[: self.n]
        grown[self.n:].zero_()
        self.data = grown
        return True

    def append(self, rows: torch.Tensor) -> tuple:
        """Append rows; returns (start, grew)."""
        start = self.n
        grew = self.reserve(start + rows.shape[0])
        self.data[start: start + rows.shape[0]] = rows
        self.n = start + rows.shape[0]
        return start, grew

    def write(self, ids: torch.Tensor, rows) -> None:
        """In-place overwrite of the rows at ids (the upsert path)."""
        self.data[ids] = rows


def as_ids(ids, device) -> torch.Tensor:
    """Ids as a flat int64 tensor on ``device``."""
    return torch.as_tensor(ids, device=device).reshape(-1).long()


class MutationMixin:
    """Bookkeeping shared by every mutable engine: counters, generation,
    the id space, the dirty flag that re-points query-side tensors after a
    write, and id validation. Engines set ``self.device``."""

    def _mut_init(self, n: int = 0) -> None:
        self.mutation_stats = {"inserts": 0, "deletes": 0, "upserts": 0,
                               "compactions": 0}
        self.generation = 0
        self.next_id = int(n)  # id space is append-only, never reused
        self._dirty = True

    def _record(self, kind: str, n: int) -> None:
        self.mutation_stats[kind] += int(n)
        self.generation += 1
        self._dirty = True

    def _write_mirrors(self, ids, pairs) -> None:
        """Write rows into each (GrowableRows, values) pair at the given
        ids, growing each buffer to the id space first (None on either side:
        that buffer is not kept, skip)."""
        for g, values in pairs:
            if g is None or values is None:
                continue
            g.reserve(self.next_id)
            g.write(ids, values.to(g.data.dtype))
            g.n = max(g.n, self.next_id)

    def _reserve_mirrors(self, extra_rows: int, mirrors) -> None:
        """Grow each kept buffer once to hold ``extra_rows`` more ids (the
        engines' ``reserve``)."""
        for g in mirrors:
            if g is not None:
                g.reserve(self.next_id + int(extra_rows), exact=True)
        self._dirty = True

    def _tombstone_valid(self, ids) -> torch.Tensor:
        """Tombstone ids in the engine's ``_valid`` live mask; returns the
        ids that were live, filtered by the mask before it is written, so a
        live id given twice is returned twice (as in the reference);
        out-of-range and dead ids are dropped."""
        ids = as_ids(ids, self.device)
        ids = ids[(ids >= 0) & (ids < self._valid.n)]
        ids = ids[self._valid.data[ids]]
        self._valid.data[ids] = False
        return ids

    @staticmethod
    def _id_facts(ids) -> tuple:
        """(min, max, distinct count) of a non-empty id batch."""
        distinct = torch.unique(ids)
        lo, hi = distinct[[0, -1]].tolist()
        return lo, hi, distinct.numel()

    def _take_ids(self, n: int, ids=None) -> torch.Tensor:
        """Assign (or validate caller-given) ids for n inserted rows.
        Explicit ids must be fresh, at or beyond the id space, so that an
        insert never shadows a live row (that is upsert)."""
        if ids is None:
            ids = torch.arange(self.next_id, self.next_id + n,
                               dtype=torch.int64, device=self.device)
        else:
            ids = as_ids(ids, self.device)
            if ids.shape != (n,):
                raise ValueError(f"{ids.shape[0]} ids for {n} rows")
            if n:
                lo, hi, distinct = self._id_facts(ids)
                if lo < self.next_id:
                    raise ValueError(
                        f"insert ids must be fresh (>= {self.next_id}); use "
                        "upsert to re-encode existing ids in place")
                if distinct != n:
                    raise ValueError("duplicate ids in one insert batch")
                self.next_id = max(self.next_id, hi + 1)
                return ids
        self.next_id += n
        return ids

    def _check_upsert_ids(self, n: int, ids) -> torch.Tensor:
        if ids is None:
            raise ValueError("upsert needs explicit ids; use insert for "
                             "fresh rows")
        ids = as_ids(ids, self.device)
        if ids.shape != (n,):
            raise ValueError(f"{ids.shape[0]} ids for {n} rows")
        if n:
            lo, hi, distinct = self._id_facts(ids)
            if lo < 0 or hi >= self.next_id:
                raise ValueError(
                    f"upsert ids must name existing rows (< {self.next_id})")
            if distinct != n:
                raise ValueError("duplicate ids in one upsert batch")
        return ids
