"""Carry trained state from the reference package into the port: an
engine's (``from_reference_state``) and a model's parameters
(``from_reference_params``).

K-means in the reference draws from ``jax.random`` and in the port from a
``torch.Generator``, so the two train different centroids from one seed.
What crosses is the trained state itself: the numpy leaves of the
reference's ``PQIndex.state_dict()`` or ``IVFPQIndex.state_dict()`` (or
its flat corpus, or its ``LSHIndex``'s planes, codes, corpus and
corpus_sq, an engine with no state_dict), or the npz leaves of a
``save_index`` snapshot, become what the port's ``load_state`` takes;
an ``IVFPQIndex(scan_all=True)`` keeps the state's row-major codes
beside the layout it rebuilds. Nothing
here imports the reference package.
"""
from __future__ import annotations

import numpy as np
import torch


def from_reference_state(state: dict) -> dict:
    """{leaf name: array-like} -> {leaf name: torch.Tensor, int or str}.

    String leaves (engine, metric) become ``str``, scalar leaves (d,
    generation) ``int``, array leaves CPU tensors of the same dtype (a
    copy, since the reference's arrays are read-only), except uint32 (LSH
    signature words), which become int32 tensors of the same bits;
    ``load_state`` moves them to the engine's device.
    """
    out = {}
    for key, value in state.items():
        arr = np.asarray(value)
        if arr.dtype.kind in "US":
            out[key] = str(arr)
        elif arr.ndim == 0:
            out[key] = arr.item()
        elif arr.dtype == np.uint32:
            out[key] = torch.tensor(arr.view(np.int32))
        else:
            out[key] = torch.tensor(arr)
    return out


def _flatten(tree, prefix=""):
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, dict):
            yield from _flatten(value, name + ".")
        elif value is not None:
            yield name, value


def from_reference_params(tree: dict, cfg) -> dict:
    """The reference transformer's (or encoder's) parameter tree, as nested
    dicts of numpy arrays, -> the port's ``state_dict``.

    Names are the tree's paths joined by dots. The reference stacks the
    ``dense_blocks`` leaves over layers on axis 0 (one ``jax.vmap`` init);
    they become ``dense_blocks.<i>.<path>``, one entry a layer. Every leaf
    keeps its layout ((d, h, dh) for ``wq``, (h, dh, d) for ``wo``) and
    dtype. ``lm_head`` is dropped: ``encode`` never reads it and the port's
    model has none. MoE blocks and the MTP head are refused, as the port's
    ``init`` refuses them.
    """
    out = {}
    for key, sub in tree.items():
        if key == "lm_head" or sub is None:
            continue
        if key in ("moe_blocks", "mtp"):
            raise NotImplementedError(
                f"{key} come with the LM stack (ROADMAP.md Queue 1, item 8)")
        if key == "dense_blocks":
            for name, leaf in _flatten(sub):
                arr = np.asarray(leaf)
                if arr.shape[0] != cfg.n_dense_layers:
                    raise ValueError(f"dense_blocks.{name} stacks {arr.shape[0]} "
                                     f"layers, config has {cfg.n_dense_layers}")
                for i in range(cfg.n_dense_layers):
                    out[f"dense_blocks.{i}.{name}"] = torch.tensor(arr[i])
        elif isinstance(sub, dict):
            for name, leaf in _flatten(sub, key + "."):
                out[name] = torch.tensor(np.asarray(leaf))
        else:
            out[key] = torch.tensor(np.asarray(sub))
    return out
