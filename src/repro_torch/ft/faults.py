"""Fault injection: crash-point hooks and the step-based failure injector
(port of ``repro.ft.faults``; pure Python, a copy of the reference's).

  * ``crashpoint(name)`` is called by durability-critical code at every
    commit-protocol boundary (WAL append, fsync and truncate; snapshot
    write, manifest, rename and directory fsync). Unarmed it costs one list
    check; under ``inject_crashes`` the named point raises
    ``SimulatedCrash``, which models the process dying at that boundary:
    what is on disk stays, what is in memory the test discards, and
    recovery must rebuild a consistent state from the disk alone.
    ``CRASH_POINTS`` lists every registered point, so a recovery test can
    parametrize over all of them; firing an unlisted point under an armed
    injector is an assertion error.
  * ``FailureInjector`` raises ``NodeFailure`` at configured steps (the
    training supervisor's fault model).

``SimulatedCrash`` subclasses ``BaseException``: recovery paths under test
hold ``except Exception`` blocks (skipping a corrupt snapshot step), and an
injected crash must never be swallowed by the code it tests.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Union

# every registered commit-protocol boundary, in rough commit order: the WAL
# points fire in core.wal, the snapshot points in checkpoint.store, and
# wal.truncate.pre in VectorDB.save_index (between the snapshot commit and
# the log truncation it authorizes)
CRASH_POINTS = (
    "wal.append.pre",        # before the record's bytes reach the file
    "wal.append.post",       # record written (+flushed), not yet fsync'd
    "wal.sync.post",         # record fsync'd: the durability point
    "wal.truncate.pre",      # snapshot committed, WAL not yet truncated
    "snapshot.write.pre",    # before any snapshot bytes are written
    "snapshot.manifest.post",  # leaves + manifest in step_<n>.tmp/
    "snapshot.rename.pre",   # complete tmp dir, final name not yet taken
    "snapshot.rename.post",  # renamed, parent directory not yet fsync'd
    "snapshot.fsync.post",   # fully committed snapshot
)


class SimulatedCrash(BaseException):
    """An injected process death at a named crash point (a BaseException,
    so that no ``except Exception`` recovery path survives it)."""


class NodeFailure(RuntimeError):
    """Simulated node loss or preemption."""


@dataclasses.dataclass
class FailureInjector:
    """Raises NodeFailure at the given steps (once each)."""

    fail_at: Sequence[int] = ()
    permanent_from: Optional[int] = None  # step after which a device is gone

    def __post_init__(self):
        self._pending = set(self.fail_at)

    def check(self, step: int):
        if step in self._pending:
            self._pending.discard(step)
            raise NodeFailure(f"injected failure at step {step}")
        if self.permanent_from is not None and step >= self.permanent_from:
            raise NodeFailure(f"injected permanent device loss at step {step}")


class CrashPointInjector:
    """Arms a set of crash points; each fires on its n-th hit (default the
    first). ``fired`` records the points that raised, so a test can assert
    that its scenario reached the boundary."""

    def __init__(self, points: Union[Dict[str, int], Iterable[str]]):
        if not isinstance(points, dict):
            points = {p: 1 for p in points}
        unknown = set(points) - set(CRASH_POINTS)
        if unknown:
            raise ValueError(f"unknown crash points {sorted(unknown)}; "
                             f"registered: {CRASH_POINTS}")
        self.arm = dict(points)
        self.hits = {p: 0 for p in points}
        self.fired: List[str] = []

    def check(self, name: str) -> None:
        if name not in self.arm:
            return
        self.hits[name] += 1
        if self.hits[name] == self.arm[name]:
            self.fired.append(name)
            raise SimulatedCrash(name)


_ACTIVE: List[CrashPointInjector] = []  # stack: nested with-blocks compose


def crashpoint(name: str) -> None:
    """Hook at a commit-protocol boundary: a no-op unless an injector is
    armed for this point (then SimulatedCrash)."""
    if not _ACTIVE:
        return
    assert name in CRASH_POINTS, f"unregistered crash point {name!r}"
    for inj in _ACTIVE:
        inj.check(name)


@contextlib.contextmanager
def inject_crashes(points, hits: int = 1):
    """Arm crash points for the with-block.

    ``points``: one name, an iterable of names, or {name: nth_hit};
    ``hits``: which hit fires, for the non-dict forms (1 = first).
    Yields the injector, whose ``.fired`` the caller can check.
    """
    if isinstance(points, str):
        points = {points: hits}
    elif not isinstance(points, dict):
        points = {p: hits for p in points}
    inj = CrashPointInjector(points)
    _ACTIVE.append(inj)
    try:
        yield inj
    finally:
        _ACTIVE.remove(inj)
