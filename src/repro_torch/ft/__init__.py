"""Fault tolerance (port of ``repro.ft``): crash-point fault injection.
The training supervisor comes with the training stack (ROADMAP.md Queue 1,
item 8)."""
from repro_torch.ft.faults import (CRASH_POINTS, CrashPointInjector,
                                   FailureInjector, NodeFailure,
                                   SimulatedCrash, crashpoint, inject_crashes)

__all__ = ["CRASH_POINTS", "CrashPointInjector", "FailureInjector",
           "NodeFailure", "SimulatedCrash", "crashpoint", "inject_crashes"]
