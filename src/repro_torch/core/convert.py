"""Carry trained state between the reference package and the port: an
engine's (``from_reference_state``), a model's parameters
(``from_reference_params``; ``stack_layers`` the other way) and a train
state (``from_reference_train_state``, ``to_reference_train_state``).

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
from torch import nn

from repro_torch.search.meta import STATE_PREFIX
from repro_torch.train.optim import tree_build


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
    """(dotted name, leaf) of a tree of dicts and lists, a list item named
    by its index (``attn.0.wq``, as a ``ModuleList`` names it)."""
    items = enumerate(tree) if isinstance(tree, (list, tuple)) else tree.items()
    for key, value in items:
        name = f"{prefix}{key}"
        if isinstance(value, (dict, list, tuple)):
            yield from _flatten(value, name + ".")
        elif value is not None:
            yield name, value


def _stacks(cfg) -> dict:
    """{stacked subtree: its layer count}: the reference's ``jax.vmap``
    inits stack these leaves over axis 0. Only the transformer stacks
    layers; the recsys and GNN trees hold their layers in lists."""
    if not hasattr(cfg, "n_dense_layers"):
        return {}
    return {"dense_blocks": cfg.n_dense_layers,
            "moe_blocks": cfg.n_moe_layers,
            "mtp": cfg.mtp_depth}


def from_reference_params(tree: dict, cfg) -> dict:
    """A reference model's parameter tree (the transformer's, the
    encoder's, a recsys or GNN model's), as nested dicts and lists of
    numpy arrays (or tensors), -> the port's ``state_dict``.

    Names are the tree's paths joined by dots, a list item by its index.
    The reference stacks the transformer's ``dense_blocks``,
    ``moe_blocks`` and ``mtp`` leaves over their layers on axis 0 (one
    ``jax.vmap`` init each); they become
    ``<stack>.<i>.<path>``, one entry a layer (an MoE layer's expert axis
    kept: ``moe_blocks.<i>.moe.experts.w_up`` is (E, d, f)). Every leaf
    keeps its layout ((d, h, dh) for ``wq``, (h, dh, d) for ``wo``) and
    dtype, ``lm_head`` included.
    """
    out = {}
    stacks = _stacks(cfg)
    for key, sub in tree.items():
        if sub is None:
            continue
        if key in stacks:
            n = stacks[key]
            for name, leaf in _flatten(sub):
                arr = _as_tensor(leaf)
                if arr.shape[0] != n:
                    raise ValueError(f"{key}.{name} stacks {arr.shape[0]} "
                                     f"layers, config has {n}")
                for i in range(n):
                    out[f"{key}.{i}.{name}"] = arr[i].clone()
        elif isinstance(sub, (dict, list, tuple)):
            for name, leaf in _flatten(sub, key + "."):
                out[name] = _as_tensor(leaf)
        else:
            out[key] = _as_tensor(sub)
    return out


def _as_tensor(leaf) -> torch.Tensor:
    """A CPU tensor copy of a numpy leaf (bf16 by its bits), or the tensor."""
    if isinstance(leaf, torch.Tensor):
        return leaf
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":
        return torch.tensor(arr.view(np.int16)).view(torch.bfloat16)
    return torch.tensor(arr)


def _nest(flat: dict) -> dict:
    """{"a.b.c": x} -> {"a": {"b": {"c": x}}}; a level named by indices
    (a ``ModuleList``'s "0", "1", ...) becomes a list."""
    return tree_build((tuple(int(p) if p.isdigit() else p
                             for p in name.split(".")), leaf)
                      for name, leaf in flat.items())


def stack_layers(named: dict, cfg) -> dict:
    """The port's per-layer names ({name: tensor}: a ``state_dict``, the
    parameters or their gradients) -> the reference's tree: nested dicts by
    path, each ``dense_blocks``, ``moe_blocks`` and ``mtp`` leaf stacked
    over its layers on axis 0 (``torch.stack``, a copy). The inverse of
    ``from_reference_params``."""
    stacks = _stacks(cfg)
    top = {}
    layers = {key: [dict() for _ in range(n)] for key, n in stacks.items()}
    for name, leaf in named.items():
        key = name.split(".", 1)[0]
        if key in stacks:
            _, i, rest = name.split(".", 2)
            layers[key][int(i)][rest] = leaf
        else:
            top[name] = leaf
    tree = _nest(top)
    for key, stack in layers.items():
        if not stack:
            continue
        if any(set(layer) != set(stack[0]) for layer in stack):
            raise ValueError(f"{key} layers hold different leaves")
        tree[key] = _nest({rest: torch.stack([layer[rest] for layer in stack])
                           for rest in stack[0]})
    return tree


def bind_reference_layout(model, cfg) -> dict:
    """The model's parameters as the reference's tree, sharing storage:
    each ``dense_blocks``, ``moe_blocks`` and ``mtp`` leaf becomes one
    (L, ...) tensor (an MoE leaf keeps its expert axis after L) and every
    layer's parameter is re-registered as a view of its slice; the other
    leaves are the parameters themselves (detached aliases), in dicts and
    lists as the reference nests them (a recsys or GNN model has no
    stacks). A write into the tree is a write into the model. The
    optimizer runs over this tree, so that Adam moments (the int8 blocks
    too, which the reference forms over the stacked leaf) have the
    reference's layout leaf for leaf. Bind after the model has moved to
    its device: ``Module.to`` replaces the storage."""
    tree = stack_layers({n: p.detach() for n, p in model.named_parameters()},
                        cfg)
    for key in _stacks(cfg):
        for i, layer in enumerate(getattr(model, key, None) or ()):
            for rest, param in list(layer.named_parameters()):
                stacked = tree[key]
                for part in rest.split("."):
                    stacked = stacked[part]
                owner_path, _, leaf = rest.rpartition(".")
                setattr(layer.get_submodule(owner_path), leaf,
                        nn.Parameter(stacked[i],
                                     requires_grad=param.requires_grad))
    return tree


def _map_tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_tree(v, fn) for k, v in tree.items() if v is not None}
    if isinstance(tree, (list, tuple)):
        return [_map_tree(v, fn) for v in tree]
    return fn(tree)


def from_reference_train_state(state: dict, cfg) -> dict:
    """The reference's train state ``{"params", "opt": {"mu", "step"}}``
    (nested dicts of numpy arrays, as ``jax.tree.map(np.asarray, state)``
    gives it; ``mu`` holds {"m", "v"} or int8 {"m_q", "m_s", "v_q",
    "v_s"} a leaf) -> the port's: the same tree of CPU tensors, in the
    reference's layout (``dense_blocks`` stacked, which is the layout the
    port's optimizer runs over; ``from_reference_params(state["params"],
    cfg)`` gives a model's ``state_dict``), ``step`` a 0-d int32 tensor.
    Leaves are copied bit for bit; a dense_blocks leaf that does not stack
    ``cfg``'s layer count is refused."""
    out = _map_tree(state, _as_tensor)
    _check_layers(out, cfg)
    return out


def to_reference_train_state(state: dict, cfg) -> dict:
    """The port's train state (``{"params": a reference-layout tree, as
    ``bind_reference_layout`` gives it, "opt": as ``train.adamw_init``
    makes it}``) -> the reference's, as numpy leaves. A bf16 leaf comes
    back as its uint16 bits, as checkpoint files hold it.
    ``checkpoint.save`` of the port's state writes the same files."""
    _check_layers(state, cfg)

    def leaf(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16).copy()
        return t.numpy().copy()

    return _map_tree({"params": state["params"], "opt": state["opt"]}, leaf)


def _check_layers(state: dict, cfg) -> None:
    """Every ``dense_blocks``, ``moe_blocks`` and ``mtp`` leaf of the
    parameters and moments stacks ``cfg``'s layer count of its kind, but a
    flat int8 block list, which spans the whole stack."""
    for key, n in _stacks(cfg).items():
        for sub in (state["params"].get(key), state["opt"]["mu"].get(key)):
            for name, leaf in _flatten(sub or {}):
                flat_int8 = (leaf.ndim == 1 and name.rsplit(".", 1)[-1]
                             in ("m_q", "m_s", "v_q", "v_s"))
                if not flat_int8 and (leaf.ndim == 0 or leaf.shape[0] != n):
                    raise ValueError(f"{key}.{name} of shape "
                                     f"{tuple(leaf.shape)} does not stack "
                                     f"{n} layers")
