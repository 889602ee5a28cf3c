"""Sharding rules: params / optimizer / batch / cache -> PartitionSpec trees,
and the placements that realize them on a ``DeviceMesh`` (port of
``repro.launch.sharding``).

Scheme (MaxText-lineage, the reference's):
  * tensor parallel over "model": attention heads, expert dim (EP), d_ff,
    vocab, embedding-table rows, candidate-corpus rows;
  * FSDP over ("pod","data"): the largest non-model dim of every weight
    (ZeRO-3: DTensor all-gathers a weight where an op needs it whole);
  * batch over ("pod","data").

Rules are keyed by leaf name and written for the TRAILING dims; any extra
leading axes are padded with None, so one table covers the reference
layout (each transformer stack one (L, ...) leaf, ``core.convert``) and
the port's module, whose unrolled layers take the trailing dims alone.
Dims that don't divide their axis (e.g. danube's 8 KV heads on a 16-way
model axis) fall back to replication, which ``explain()`` records.

A tree is a ``nn.Module`` (its parameters by dotted name -> {name: spec})
or nested dicts and lists whose leaves have a ``.shape`` (tensors on any
device, DTensors, ``launch.shapes.Spec``): the result has the same
structure, a ``PartitionSpec`` at each leaf. Specs are the port's
``core.distributed.PartitionSpec``.

``placements(spec, mesh)`` (``core.distributed.dtensor_placements``) is
the counterpart of ``NamedSharding``: one DTensor placement a mesh dim,
``Shard(d)`` on each mesh axis that tensor dim d splits over. A dim over
several axes lists them in mesh order, and DTensor splits such a dim over
its mesh dims left to right, so the row-major layout is JAX's.
``distribute`` and ``gather`` move whole trees.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.core.distributed import PartitionSpec as P
from repro_torch.core.distributed import dtensor_placements as placements
from repro_torch.launch.mesh import (axis_names, axis_size, batch_axes,
                                     fsdp_axes, mesh_shape)


def _fits(dim: int, mesh, axes) -> bool:
    """Exact divisibility, as the reference's jit shardings demand; big
    arrays that would not divide are padded at the config or spec layer
    (``launch.shapes.pad_up``)."""
    if axes is None:
        return True
    ax = (axes,) if isinstance(axes, str) else tuple(axes)
    return dim % axis_size(mesh, ax) == 0


def _spec_for(shape, rule, mesh):
    """rule: tuple over trailing dims; each entry None | axis | tuple."""
    lead = len(shape) - len(rule)
    entries = [None] * lead + [
        (ax if _fits(shape[lead + i], mesh, ax) else None)
        for i, ax in enumerate(rule)
    ]
    return P(*entries)


# --------------------------------------------------------------- trees


def _paths(tree, prefix=()):
    """[(names, leaf)]: a module's parameters by dotted name split into
    parts, else the leaves of nested dicts and lists (None skipped)."""
    if isinstance(tree, nn.Module):
        return [(tuple(n.split(".")), p) for n, p in tree.named_parameters()]
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return [(prefix, tree)] if tree is not None else []
    out = []
    for key, sub in items:
        out.extend(_paths(sub, prefix + (str(key),)))
    return out


def tree_map_with_names(fn, tree):
    """fn(names, leaf) at every leaf: a module gives {dotted name: value},
    a tree the same nesting (a list stays a list)."""
    if isinstance(tree, nn.Module):
        return {n: fn(tuple(n.split(".")), p)
                for n, p in tree.named_parameters()}
    return _map(fn, tree, ())


def _map(fn, tree, prefix):
    if isinstance(tree, dict):
        return {k: _map(fn, v, prefix + (str(k),)) for k, v in tree.items()
                if v is not None}
    if isinstance(tree, (list, tuple)):
        return [_map(fn, v, prefix + (str(i),)) for i, v in enumerate(tree)]
    return fn(prefix, tree)


def leaves(tree) -> list:
    """The leaves of a tree of specs, values or tensors, in ``_paths``'s
    order, with their dotted names: [(name, leaf)]."""
    return [(".".join(n), leaf) for n, leaf in _paths(tree)]


def _n_experts(params) -> int:
    for names, leaf in _paths(params):
        if "experts" in names:
            return leaf.shape[-3]
    return 0


# --------------------------------------------------------------- LM family


def _lm_rules(fsdp):
    return {
        "table": ("model", fsdp),          # embed (V, D)
        "wq": (fsdp, "model", None),       # (D, H, dh)
        "wk": (fsdp, "model", None),
        "wv": (fsdp, "model", None),
        "bq": ("model", None),
        "bk": ("model", None),
        "bv": ("model", None),
        "wo": ("model", None, fsdp),       # (H, dh, D)
        "wq_a": (fsdp, None),              # (D, q_lora)
        "wq_b": (None, "model", None),     # (q_lora, H, qk)
        "wkv_a": (fsdp, None),             # (D, lora+rope)
        "wkv_b": (None, "model", None),    # (lora, H, nope+v)
        "w_up": (fsdp, "model"),           # (D, F)
        "w_gate": (fsdp, "model"),
        "w_down": ("model", fsdp),         # (F, D)
        "router": (fsdp, None),            # (D, E)
        "w": (fsdp, "model"),              # lm_head / proj (D, V)
        "proj": (fsdp, None),
        "scale": (None,),
        "bias": (None,),
    }


def _expert_rules(mesh, n_experts: int):
    """TRAIN expert layout: EP over "model", FSDP on D (the reference
    measured the whole-mesh-EP alternatives at 2.8x and 5.2x more
    collective bytes)."""
    fsdp = fsdp_axes(mesh)
    return {
        "w_up": ("model", fsdp, None),    # (E, D, F)
        "w_gate": ("model", fsdp, None),
        "w_down": ("model", None, fsdp),  # (E, F, D)
    }, ("model",)


def _serve_lm_rules(mesh):
    """Serving shards weights ONLY over "model" (TP): FSDP-sharded weights
    would be gathered again for every generated token. Experts instead
    shard their E dim over as many axes as divide (EP eats the mesh)."""
    return {
        "table": ("model", None),
        "wq": (None, "model", None),
        "wk": (None, "model", None),
        "wv": (None, "model", None),
        "bq": ("model", None), "bk": ("model", None), "bv": ("model", None),
        "wo": ("model", None, None),
        "wq_a": (None, None),
        "wq_b": (None, "model", None),
        "wkv_a": (None, None),
        "wkv_b": (None, "model", None),
        "w_up": (None, "model"),
        "w_gate": (None, "model"),
        "w_down": ("model", None),
        "router": (None, None),
        "w": (None, "model"),
        "proj": (None, None),
        "scale": (None,), "bias": (None,),
    }


def _serve_expert_axes(mesh, n_experts: int):
    """Largest trailing-axes combo that divides E; leftover axes -> D dim."""
    names = axis_names(mesh)
    for i in range(len(names)):
        cand = names[i:]
        if n_experts % axis_size(mesh, cand) == 0:
            return cand, names[:i]
    return ("model",), tuple(a for a in names if a != "model")


def param_pspecs(params, mesh, family: str = "lm", mode: str = "train"):
    """A parameter tree (a module, or the reference layout) -> its spec
    tree. ``mode="serve"`` switches LM weights to TP only and whole-mesh EP
    (``_serve_lm_rules``); training keeps FSDP."""
    fsdp = fsdp_axes(mesh)
    n_e = _n_experts(params)
    if mode == "serve" and family in ("lm", "encoder"):
        rules = _serve_lm_rules(mesh)
        if n_e:
            e_axes, d_axes = _serve_expert_axes(mesh, n_e)
            expert_rules = {
                "w_up": (e_axes, d_axes or None, None),
                "w_gate": (e_axes, d_axes or None, None),
                "w_down": (e_axes, None, d_axes or None),
            }
        else:
            expert_rules = {}
    else:
        rules = _lm_rules(fsdp)
        expert_rules = _expert_rules(mesh, n_e)[0] if n_e else {}
    all_axes = axis_names(mesh)

    def one(names, leaf):
        name = names[-1]
        if family == "gnn":
            return P()  # tiny params: replicate
        if family == "recsys":
            if name in ("embed", "w1", "item_embed"):
                # DLRM-style row sharding over the WHOLE mesh
                return _spec_for(leaf.shape, (all_axes, None), mesh)
            return P()  # pos_embed and the small towers replicate
        if "experts" in names and name in expert_rules:
            return _spec_for(leaf.shape, expert_rules[name], mesh)
        if name in rules:
            return _spec_for(leaf.shape, rules[name], mesh)
        return P()

    return tree_map_with_names(one, params)


def _spec_at(param_specs, names):
    """The spec of the parameter at ``names`` in a spec tree (nested, or
    a module's {dotted name: spec})."""
    if isinstance(param_specs, dict) and ".".join(names) in param_specs:
        return param_specs[".".join(names)]
    spec = param_specs
    for n in names:
        spec = spec[n] if isinstance(spec, dict) else spec[int(n)]
    return spec


def opt_pspecs(opt_state, param_specs, mesh):
    """AdamW state specs. float32 moments follow their parameter exactly.
    int8 state: codes share the parameter's shape (and spec); blockwise
    scales share its leading dims (the last entry kept only if the
    shrunken scale dim still divides); a leaf in the flat layout (last dim
    off the block multiple, ``train.optim``) shards over the whole mesh if
    it divides."""
    flat_axes = axis_names(mesh)

    def mu(names, leaf):
        name = names[-1]
        if name in ("m", "v"):
            return _spec_at(param_specs, names[1:-1])  # skip "mu"
        if name in ("m_q", "v_q", "m_s", "v_s"):
            pspec = _spec_at(param_specs, names[1:-1])
            if leaf.ndim == len(tuple(pspec)):  # nd (sharding-preserving)
                entries = list(pspec)
                ax = entries[-1]
                if ax is not None and not _fits(leaf.shape[-1], mesh, ax):
                    entries[-1] = None
                return P(*entries)
            return (P(flat_axes)
                    if leaf.shape[0] % axis_size(mesh, flat_axes) == 0
                    else P())
        return P()

    return tree_map_with_names(mu, opt_state)


def batch_pspecs(batch, mesh):
    """Shard the leading (batch) dim of every leaf over the batch axes when
    it divides; other leaves (long_500k's batch of 1) replicate."""
    axes = batch_axes(mesh)
    n = axis_size(mesh, axes)

    def one(names, leaf):
        if not hasattr(leaf, "shape") or len(leaf.shape) == 0:
            return P()
        if leaf.shape[0] % n == 0:
            return P(axes, *([None] * (len(leaf.shape) - 1)))
        return P(*([None] * len(leaf.shape)))

    return tree_map_with_names(one, batch)


def gnn_batch_pspecs(batch, mesh):
    """GNN batches: node arrays shard dim 0; the (2, E) edge index shards
    dim 1 (edges are the big axis)."""
    axes = batch_axes(mesh)
    n = axis_size(mesh, axes)

    def one(names, leaf):
        if not hasattr(leaf, "shape") or len(leaf.shape) == 0:
            return P()
        nd = len(leaf.shape)
        if names and names[-1] == "edges":
            return P(None, axes) if leaf.shape[1] % n == 0 else P(None, None)
        if leaf.shape[0] % n == 0:
            return P(axes, *([None] * (nd - 1)))
        return P(*([None] * nd))

    return tree_map_with_names(one, batch)


def cache_pspecs(cache, mesh, batch: int):
    """Decode cache (L, B, C, ...): batch over the data axes, the trailing
    head or latent dim over "model" when divisible (v3's 294 GB MLA cache
    needs it)."""
    axes = batch_axes(mesh)
    b_ok = batch % axis_size(mesh, axes) == 0
    model = mesh_shape(mesh)["model"]

    def one(names, leaf):
        shape = tuple(leaf.shape)
        spec = [None, axes if b_ok else None, None] + [None] * len(shape[3:])
        if len(shape) >= 4 and shape[-1] % model == 0:
            spec[-1] = "model"
        if len(shape) == 5 and shape[3] % model == 0:
            spec[3] = "model"   # GQA: prefer sharding KV heads, not head_dim
            spec[-1] = None
        return P(*spec)

    return tree_map_with_names(one, cache)


def explain(params, specs) -> list:
    """Human-readable sharding report (dry-run log)."""
    spec_of = dict(leaves(specs))
    return [f"{name:60s} {str(tuple(leaf.shape)):28s} {spec_of[name]}"
            for name, leaf in leaves(params)]


# --------------------------------------------------------------- placements


def _entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def local_shape(shape, spec, mesh) -> tuple:
    """The shape of one rank's shard (even splits, as ``_fits`` chose)."""
    shape = list(shape)
    for d, entry in enumerate(spec):
        n = axis_size(mesh, _entry_axes(entry))
        shape[d] = -(-shape[d] // n)
    return tuple(shape)


def distribute(tree, specs, mesh):
    """Every tensor leaf of ``tree`` as a DTensor over ``mesh`` with its
    spec's placements, from the whole tensor that every rank holds (each
    keeps its own shard; nothing crosses ranks). Leaves keep their dtype
    and move to the mesh's device type. Non-tensor leaves pass through."""
    from torch.distributed.tensor import distribute_tensor
    spec_by = dict(leaves(specs))
    dev = mesh.device_type

    def one(names, leaf):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        spec = spec_by[".".join(names)]
        return distribute_tensor(leaf.detach().to(dev), mesh,
                                 placements(spec, mesh), src_data_rank=None)

    return tree_map_with_names(one, tree)


def gather(tree):
    """Every DTensor leaf as its whole tensor (``full_tensor``, an
    all-gather where it is sharded); other leaves pass through."""
    from torch.distributed.tensor import DTensor

    def one(names, leaf):
        return leaf.full_tensor() if isinstance(leaf, DTensor) else leaf

    return tree_map_with_names(one, tree)
