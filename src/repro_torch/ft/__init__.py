"""Fault tolerance (port of ``repro.ft``): crash-point fault injection
(``ft.faults``) and the training supervisor (``ft.supervisor``).

The supervisor is imported lazily (PEP 562): it depends on
``repro_torch.checkpoint``, whose store calls ``ft.faults.crashpoint`` at
its commit boundaries, so an eager import both ways would be a cycle.
"""
from repro_torch.ft.faults import (CRASH_POINTS, CrashPointInjector,
                                   FailureInjector, NodeFailure,
                                   SimulatedCrash, crashpoint, inject_crashes)

__all__ = ["CRASH_POINTS", "CrashPointInjector", "FailureInjector",
           "NodeFailure", "SimulatedCrash", "StragglerMonitor", "Supervisor",
           "TrainJob", "crashpoint", "inject_crashes"]

_LAZY = ("Supervisor", "StragglerMonitor", "TrainJob")


def __getattr__(name):
    if name in _LAZY:
        from repro_torch.ft import supervisor
        return getattr(supervisor, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
