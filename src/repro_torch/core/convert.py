"""Carry an engine's trained state from the reference package into the port.

K-means in the reference draws from ``jax.random`` and in the port from a
``torch.Generator``, so the two train different centroids from one seed.
What crosses is the trained state itself: the numpy leaves of the
reference's ``IVFPQIndex.state_dict()`` (or its flat corpus), or the npz
leaves of a ``save_index`` snapshot, become what the port's
``load_state`` takes. Nothing here imports the reference package.
"""
from __future__ import annotations

import numpy as np
import torch


def from_reference_state(state: dict) -> dict:
    """{leaf name: array-like} -> {leaf name: torch.Tensor, int or str}.

    String leaves (engine, metric) become ``str``, scalar leaves (d,
    generation) ``int``, array leaves CPU tensors of the same dtype (a
    copy, since the reference's arrays are read-only); ``load_state``
    moves them to the engine's device.
    """
    out = {}
    for key, value in state.items():
        arr = np.asarray(value)
        if arr.dtype.kind in "US":
            out[key] = str(arr)
        elif arr.ndim == 0:
            out[key] = arr.item()
        else:
            out[key] = torch.tensor(arr)
    return out
