"""Carry trained state from the reference package into the port: an
engine's (``from_reference_state``) and a model's parameters
(``from_reference_params``).

K-means in the reference draws from ``jax.random`` and in the port from a
``torch.Generator``, so the two train different centroids from one seed.
What crosses is the trained state itself: the numpy leaves of the
reference's ``PQIndex.state_dict()`` or ``IVFPQIndex.state_dict()``, or
the npz leaves of a ``save_index`` snapshot, become what the port's
``load_state`` takes (``VectorDB.load_state`` also reads a snapshot's
metadata leaves); an ``IVFPQIndex(scan_all=True)`` keeps the state's
row-major codes beside the layout it rebuilds. The reference's engines
without a ``state_dict`` cross as a dict of their attributes: ``flat``
its corpus, live mask and corpus_sq; ``lsh`` its planes, codes, corpus
and corpus_sq; ``ivf`` its centroids, buckets, fill, corpus and
corpus_sq; ``int8`` its codes, scales and corpus_sq; ``graph`` its
neighbors, corpus and corpus_sq. The reference's mesh fronts
(``dist_flat``, ``dist_pq``, ``dist_ivf_pq``) have no ``state_dict``
either: ``mesh_leaves`` reads one into numpy leaves (its sharded arrays
gathered, its host ``BlockListLayout`` array for array), and
``from_reference_state`` takes the engine itself too; the port's mesh
front of the same shard count then ``load_state``s them. Nothing here
imports the reference package.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.search.meta import STATE_PREFIX


MESH_ENGINES = ("dist_flat", "dist_pq", "dist_ivf_pq")
_LAYOUT_ARRAYS = ("slots", "codes", "block_cluster", "block_table", "bcnt",
                  "tail_fill")


def mesh_leaves(engine) -> dict:
    """A reference mesh front's state as numpy leaves: ``dist_flat`` its
    padded corpus (in its dtype) and row count; ``dist_pq`` its codebooks,
    padded codes, row count and width; ``dist_ivf_pq`` its codebooks,
    centroids, id space, generation, write counters (``writes_<kind>``)
    and its layout's arrays as ``layout_<name>``, with ``layout_pos`` (the
    flat slot of each id, -1 for none), ``layout_free`` (its free rows,
    ascending) and ``layout_tombstones``."""
    name = engine.engine_name
    leaves = {"engine": name, "metric": engine.metric}
    if name == "dist_flat":
        corpus = np.asarray(engine.corpus)
        return dict(leaves, corpus=corpus, n=int(engine.n),
                    dtype=str(corpus.dtype))
    if name == "dist_pq":
        return dict(leaves, codebooks=np.asarray(engine.codebooks),
                    codes=np.asarray(engine.codes), n=int(engine.n),
                    d=int(engine.d))
    if name != "dist_ivf_pq":
        raise ValueError(f"{name!r} is not a mesh front ({MESH_ENGINES})")
    lay = engine.layout
    pos = np.full(int(engine.next_id), -1, np.int64)
    for i, (row, slot) in lay._pos.items():
        pos[i] = row * lay.blk + slot
    leaves.update(codebooks=np.asarray(engine.codebooks),
                  centroids=np.asarray(engine.centroids), d=int(engine.d),
                  next_id=int(engine.next_id),
                  generation=int(engine.generation),
                  layout_pos=pos,
                  layout_free=np.asarray(sorted(lay._free), np.int64),
                  layout_tombstones=int(lay.tombstones))
    leaves.update({f"layout_{key}": np.asarray(getattr(lay, key))
                   for key in _LAYOUT_ARRAYS})
    leaves.update({f"writes_{kind}": int(v)
                   for kind, v in engine.mutation_stats.items()})
    return leaves


def from_reference_state(state) -> dict:
    """{leaf name: array-like} (or a reference mesh front, read through
    ``mesh_leaves``) -> {leaf name: torch.Tensor, int or str}.

    String leaves (engine, metric) become ``str``, scalar leaves (d,
    generation) ``int``, array leaves CPU tensors of the same dtype (a
    copy, since the reference's arrays are read-only), except uint32 (LSH
    signature words), which become int32 tensors of the same bits, and
    bfloat16 (ml_dtypes), which becomes ``torch.bfloat16`` by its bits;
    ``load_state`` moves them to the engine's device. The metadata leaves
    of a snapshot (``metastore__*``, host numpy on both sides) pass through
    as numpy copies.
    """
    if getattr(state, "engine_name", None) in MESH_ENGINES:
        state = mesh_leaves(state)
    out = {}
    for key, value in state.items():
        arr = np.asarray(value)
        if key.startswith(STATE_PREFIX):
            out[key] = arr.copy()
        elif arr.dtype.kind in "US":
            out[key] = str(arr)
        elif arr.ndim == 0:
            out[key] = arr.item()
        elif arr.dtype == np.uint32:
            out[key] = torch.tensor(arr.view(np.int32))
        elif arr.dtype.name == "bfloat16":
            out[key] = torch.tensor(arr.view(np.int16)).view(torch.bfloat16)
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
