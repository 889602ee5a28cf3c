"""Step builders: one program per (family x step kind) on a ``DeviceMesh``
(port of ``repro.launch.steps``).

``build_cell_program(cell, mesh)`` returns a ``BuiltStep``: the function,
its abstract arguments, their specs (and so their DTensor placements) and
what it donates. ``launch.dryrun`` traces it on fake DTensors; ``run``
distributes real tensors and runs it (``chip_smoke.py`` phase 14, the gloo
tests).

The reference hands GSPMD one jitted program and its shardings. Here the
function runs eagerly on DTensors: every rank executes the same ops on its
own shards, and DTensor inserts the collectives where a placement must
change. Where DTensor would pick another layout than the reference's
constraints, the step pins it: parameters in the training layout are
all-gathered over their FSDP axes where they are read (ZeRO-3, as GSPMD
gathers lazily per layer; the gradient's backward is the reduce-scatter),
activations are anchored at block boundaries and MoE dispatch tensors are
placed as the reference's ``with_sharding_constraint``s place them
(``moe_constraints``). The attention core (the ``flash_attention`` kernel
on a CUDA shard) and the sasrec serve step's two-level search (the
``topk_distance`` kernel) run on each rank's local shards, as the
reference's ``shard_map`` bodies do.

Training state is {"params": the reference layout (``core.convert``: each
transformer stack one (L, ...) leaf), "opt": ``train.adamw_init``'s}. A
train step donates it, as the reference's ``donate_argnums=(0,)`` does:
the gradients are accumulated and clipped in their own buffers and the
new parameters and moments are written into the state's storages a leaf
(a layer of a stack) at a time (``train.optim.adamw_update_``), so that
no second state is ever held; the step returns the caller's trees. The
model code reads parameters through a skeleton module built
on the ``meta`` device (``abstract_state``), whose slots are bound, for
the step's duration, to views of the state's leaves.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import GNNConfig, LMConfig, RecsysConfig
from repro_torch.core import convert
from repro_torch.core import distances as D
from repro_torch.core.distributed import (P, contiguous_stride,
                                          with_sharding_constraint)
from repro_torch.device import float32_bf16_sums, is_dtensor, strict_fp32
from repro_torch.launch import sharding as shard_lib
from repro_torch.launch.mesh import axis_names, batch_axes
from repro_torch.launch.shapes import CellSpec
from repro_torch.models import encoder as enc_lib
from repro_torch.models import gnn as gnn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import recsys as rec_lib
from repro_torch.models import transformer
from repro_torch.models.layers import MetaGenerator
from repro_torch.train.optim import (adamw_init, adamw_update,
                                     adamw_update_, clip_by_global_norm,
                                     clip_by_global_norm_, cosine_schedule,
                                     tree_build, tree_paths)


# --------------------------------------------------------------- BuiltStep


@dataclasses.dataclass
class BuiltStep:
    """``fn(*args)`` and what a launcher needs around it: ``args`` abstract
    trees (``Spec`` or ``meta`` tensors, Python scalars), ``in_specs`` a
    spec tree each, ``out_specs`` the outputs' (None where DTensor decides),
    the ``mesh``, and the arguments it donates. A donated argument is
    written in place: after a train step the caller's state (argument 0)
    IS the new state, every leaf in its own storage, and the step returns
    those same trees; a decode step writes the new position into the
    caller's cache (argument 2). Keep a copy of a state that must outlive
    the step."""

    fn: Callable
    args: Tuple
    in_specs: Tuple
    out_specs: Any
    mesh: Any
    donate_argnums: Tuple[int, ...] = ()
    name: str = ""

    def __post_init__(self):
        self.fn = spmd(self.fn)

    def in_placements(self):
        """Each argument's tree of DTensor placements."""
        return tuple(shard_lib.tree_map_with_names(
            lambda _n, s: shard_lib.placements(s, self.mesh), specs)
            if specs is not None else None for specs in self.in_specs)

    def abstract_args(self):
        """The arguments as DTensors whose local shards are empty tensors:
        under ``FakeTensorMode`` fake ones, which allocate nothing. A
        0-d ``step`` counter is the host int 0 (the schedule reads its
        value, which a fake tensor has not)."""
        from torch.distributed.tensor import DTensor
        out = []
        for tree, specs in zip(self.args, self.in_specs):
            if specs is None:
                out.append(tree)
                continue
            spec_by = dict(shard_lib.leaves(specs))

            def one(names, leaf, spec_by=spec_by):
                if not hasattr(leaf, "shape"):
                    return leaf
                if names and names[-1] == "step" and len(leaf.shape) == 0:
                    return 0
                spec = spec_by[".".join(names)]
                local = torch.empty(
                    shard_lib.local_shape(leaf.shape, spec, self.mesh),
                    dtype=leaf.dtype, device=self.mesh.device_type)
                return DTensor.from_local(
                    local, self.mesh, shard_lib.placements(spec, self.mesh),
                    run_check=False, shape=torch.Size(leaf.shape),
                    stride=contiguous_stride(leaf.shape))

            out.append(shard_lib.tree_map_with_names(one, tree))
        return tuple(out)

    def distribute(self, *args):
        """Real whole arguments (every rank holds the same) -> DTensors by
        ``in_specs``; a train state's ``step`` stays a host tensor."""
        out = []
        for tree, specs in zip(args, self.in_specs):
            if specs is None:
                out.append(tree)
                continue
            out.append(_distribute_state(tree, specs, self.mesh))
        return tuple(out)

    def run(self, *args):
        """Distribute ``args`` and run the step; outputs are DTensors
        (``sharding.gather`` makes them whole)."""
        return self.fn(*self.distribute(*args))


def spmd(fn):
    """``fn`` run under DTensor's ``implicit_replication`` (a plain tensor
    that the model code makes inside a step, positions, masks, zeros, is
    the same on every rank and counts as replicated, as a constant does in
    a jitted program). An op DTensor has no sharding rule for raises:
    the model code runs such an op on local shards itself."""
    import functools

    @functools.wraps(fn)
    def run(*args, **kwargs):
        from torch.distributed.tensor.experimental import implicit_replication
        with implicit_replication():
            return fn(*args, **kwargs)

    return run


def _distribute_state(tree, specs, mesh):
    out = shard_lib.distribute(tree, specs, mesh)
    opt = tree.get("opt") if isinstance(tree, dict) else None
    if isinstance(opt, dict) and "step" in opt:
        out["opt"]["step"] = opt["step"]  # the schedule reads it on the host
    return out


# --------------------------------------------------------------- helpers


def train_options(arch_id: str, family: str) -> Dict:
    """Per-arch training knobs (microbatching, int8 optimizer state)."""
    if arch_id == "deepseek-v3-671b":
        # 61L x (B/dev, S, 7168) bf16 residual checkpoints: B/dev must be ~1
        return {"n_micro": 16, "int8_opt": True, "remat": True}
    if arch_id == "deepseek-v2-lite-16b":
        return {"n_micro": 4, "int8_opt": False, "remat": True}
    if family in ("lm", "encoder"):
        return {"n_micro": 2, "int8_opt": False, "remat": True}
    return {"n_micro": 1, "int8_opt": False, "remat": False}


def _family_init(family: str):
    return {"lm": transformer.init, "encoder": enc_lib.init,
            "gnn": gnn_lib.init, "recsys": rec_lib.init}[family]


def skeleton(cfg, family: str, init_fn=None):
    """The family's model built on the ``meta`` device: every leaf has the
    shape and dtype ``init`` gives it, nothing is drawn or allocated."""
    init = init_fn or _family_init(family)
    return init(cfg, MetaGenerator(), device="meta")


def abstract_state(cfg, family: str, *, int8_opt: bool, init_fn=None):
    """{"params", "opt"} of ``meta`` tensors, without allocating anything:
    the same module trees that ``init`` builds (the same constructors, on
    the meta device), in the reference layout, and ``adamw_init``'s state
    over them (its ``step`` a host tensor)."""
    model = skeleton(cfg, family, init_fn)
    params = convert.stack_layers(
        {n: p.detach() for n, p in model.named_parameters()}, cfg)
    return {"params": params, "opt": adamw_init(params, int8_state=int8_opt)}


def state_pspecs(state, mesh, family: str):
    p_specs = shard_lib.param_pspecs(state["params"], mesh, family)
    o_specs = shard_lib.opt_pspecs(state["opt"], p_specs, mesh)
    return {"params": p_specs, "opt": o_specs}


@contextlib.contextmanager
def moe_constraints(cfg, mesh, mode: str = "train"):
    """Install the activation-sharding hooks for one sharded step and take
    them off after it (tests share one process): expert-parallel dispatch
    placements (MoE) and model-sharded logits.

    The reference's mode split (each its best measured configuration):
      train:   dispatch stays G-sharded, x_e E over "model" (weights FSDP);
      decode:  x_e E over the whole mesh (weights stationary);
      prefill: no constraint."""
    prev = (moe_lib.EP_SHARDING, transformer.ACT_SHARDING)
    if isinstance(cfg, LMConfig) and cfg.moe is not None and mesh is not None:
        if mode == "decode":
            e_axes, _ = shard_lib._serve_expert_axes(mesh, cfg.moe.n_routed)
            moe_lib.EP_SHARDING = (mesh, batch_axes(mesh), e_axes)
        elif mode == "prefill":
            moe_lib.EP_SHARDING = None
        else:
            moe_lib.EP_SHARDING = (mesh, batch_axes(mesh), ("model",))
    else:
        moe_lib.EP_SHARDING = None
    transformer.ACT_SHARDING = ((mesh, batch_axes(mesh))
                                if mesh is not None and isinstance(cfg, LMConfig)
                                else None)
    try:
        yield
    finally:
        moe_lib.EP_SHARDING, transformer.ACT_SHARDING = prev


def _gather_fsdp(x, mesh):
    """A DTensor parameter made whole over the batch (FSDP) axes it splits
    over; its "model" split stays. The backward is the reduce-scatter."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard
    dp = set(batch_axes(mesh))
    names = axis_names(mesh)
    pl = [Replicate() if (isinstance(p, Shard) and names[i] in dp) else p
          for i, p in enumerate(x.placements)]
    return x if tuple(pl) == tuple(x.placements) else x.redistribute(mesh, pl)


def _leaf_at(tree, names):
    for n in names:
        tree = tree[n] if isinstance(tree, dict) else tree[int(n)]
    return tree


def _set_slots(module, values):
    """Point ``module``'s parameter slots at ``values`` ({dotted name:
    tensor}); returns what they held."""
    saved = {}
    for name, value in values.items():
        owner_path, _, leaf = name.rpartition(".")
        owner = module.get_submodule(owner_path)
        saved[name] = owner._parameters[leaf]
        owner._parameters[leaf] = value
    return saved


@contextlib.contextmanager
def _gathered_layer(block, mesh):
    """The block's parameters whole over their FSDP axes for the block
    (``transformer.LAYER_GATHER``)."""
    saved = _set_slots(block, {n: _gather_fsdp(p, mesh)
                               for n, p in block.named_parameters()})
    try:
        yield
    finally:
        _set_slots(block, saved)


@contextlib.contextmanager
def bound(model, tree, cfg, *, gather=None):
    """Bind ``model``'s parameter slots to ``tree`` (the reference layout)
    for the block: a stacked leaf's layer i is ``leaf[i]`` (a view, in the
    autograd graph). With ``gather`` (a mesh), parameters are made whole
    over their FSDP axes where they are read: the layers' one layer at a
    time, as the stack runs it (``transformer.LAYER_GATHER``), the others
    at once. The skeleton's own parameters come back after."""
    stacks = convert._stacks(cfg)
    values = {}
    for name, _ in model.named_parameters():
        parts = name.split(".")
        if parts[0] in stacks:
            values[name] = _leaf_at(tree, [parts[0]] + parts[2:])[
                int(parts[1])]
        else:
            value = _leaf_at(tree, parts)
            values[name] = (value if gather is None
                            else _gather_fsdp(value, gather))
    saved = _set_slots(model, values)
    prev = transformer.LAYER_GATHER
    if gather is not None:
        transformer.LAYER_GATHER = lambda block: _gathered_layer(block,
                                                                 gather)
    try:
        yield model
    finally:
        transformer.LAYER_GATHER = prev
        _set_slots(model, saved)


def _micro(batch, i: int, n: int):
    """Micro-batch i of n: rows [i * B / n, (i + 1) * B / n) of the global
    batch, the reference's contiguous slice, laid out as the batch was (a
    split batch is made whole over its axes, sliced, and split again)."""
    if n <= 1:
        return batch
    from torch.distributed.tensor import Replicate

    def one(names, x):
        size = x.shape[0] // n
        if not is_dtensor(x):
            return x[i * size:(i + 1) * size]
        mesh = x.device_mesh
        whole = x.redistribute(mesh, [Replicate()] * mesh.ndim)
        return whole[i * size:(i + 1) * size].redistribute(mesh, x.placements)

    return shard_lib.tree_map_with_names(one, batch)


def _value_and_grad(loss_fn, model, params, cfg, batch, mesh, gather: bool,
                    into=None):
    """((loss, metrics), grads) of ``loss_fn(model, batch)`` with the
    model bound to ``params`` (the reference layout); grads float32, in
    that layout, each on its parameter's placements (the reference's
    ``constrain``). Forward and backward run under ``float32_bf16_sums``
    and ``strict_fp32``, as ``train.accum.value_and_grad``. ``into`` (a
    list of float32 buffers in ``tree_paths`` order) takes each gradient
    added in place, a leaf at a time, each leaf's own gradient dropped
    once it is added; the grads returned are then those buffers."""
    paths = tree_paths(params)
    leaves = [t.detach().requires_grad_(True) for _, t in paths]
    tree = tree_build((path, t) for (path, _), t in zip(paths, leaves))
    with float32_bf16_sums(), strict_fp32(), \
            bound(model, tree, cfg, gather=mesh if gather else None):
        loss, metrics = loss_fn(model, batch)
        got = list(torch.autograd.grad(loss, leaves, allow_unused=True))
    grads = []
    for j, t in enumerate(leaves):
        g, got[j] = got[j], None
        g = torch.zeros_like(t, dtype=torch.float32) if g is None else g.float()
        if is_dtensor(g) and g.placements != t.placements:
            g = g.redistribute(t.device_mesh, t.placements)
        if into is not None:
            g = into[j].add_(g)
        grads.append(g)
    return ((loss.detach(), {k: v.detach() for k, v in metrics.items()}),
            tree_build((path, g) for (path, _), g in zip(paths, grads)))


def accumulate(loss_fn, model, params, cfg, batch, n_micro: int, mesh,
               gather: bool):
    """(grads, loss, metrics), each summed over ``n_micro`` micro-batches
    (``_micro``) and scaled by 1 / n_micro, as the reference's
    ``gradient_accumulation``; the gradients in one buffer (the first
    micro-batch's), each later micro-batch's added to it a leaf at a time
    and the sum scaled in place."""
    acc = loss_acc = m_acc = None
    for i in range(max(n_micro, 1)):
        (loss, metrics), grads = _value_and_grad(
            loss_fn, model, params, cfg, _micro(batch, i, n_micro), mesh,
            gather, into=acc)
        if acc is None:
            acc, loss_acc, m_acc = ([g for _, g in tree_paths(grads)], loss,
                                    metrics)
            continue
        loss_acc = loss_acc + loss
        m_acc = {k: m_acc[k] + metrics[k] for k in m_acc}
    if n_micro <= 1:
        return grads, loss_acc, m_acc
    inv = 1.0 / n_micro
    for g in acc:
        g.mul_(inv)
    return (grads, loss_acc * inv, {k: v * inv for k, v in m_acc.items()})


# --------------------------------------------------------------- LM steps


def _update(grads, state, *, donate: bool, stacked=(), **kw):
    """Clip at 1.0 and AdamW: (new state, grad norm). ``donate`` writes
    into the state (``clip_by_global_norm_``, ``adamw_update_``: the same
    bits as the functional pair, no second state)."""
    if donate:
        gn = clip_by_global_norm_(grads, 1.0)
        params, opt = adamw_update_(grads, state["opt"], state["params"],
                                    stacked=stacked, **kw)
    else:
        grads, gn = clip_by_global_norm(grads, 1.0)
        params, opt = adamw_update(grads, state["opt"], state["params"], **kw)
    return {"params": params, "opt": opt}, gn


def make_lm_train(cfg: LMConfig, mesh, arch_id: str, inputs,
                  family: str = "lm", opts: Optional[Dict] = None,
                  with_opt: bool = True, donate: bool = True) -> BuiltStep:
    """with_opt=False builds the grads-only twin (accounting separates the
    once-per-step optimizer cost from the per-microbatch fwd/bwd cost).
    ``donate=False`` returns a new state and leaves the caller's (the
    functional step, to compare the donated one with)."""
    opts = opts or train_options(arch_id, family)
    state = abstract_state(cfg, family, int8_opt=opts["int8_opt"])
    s_specs = state_pspecs(state, mesh, family)
    model = skeleton(cfg, family)

    def loss_fn(m, b):
        if family == "encoder":
            return enc_lib.contrastive_loss(m, cfg, b)
        return transformer.loss_fn(m, cfg, b, remat=opts["remat"])

    def step(state, batch):
        with moe_constraints(cfg, mesh):
            grads, loss_v, metrics = accumulate(
                loss_fn, model, state["params"], cfg, batch, opts["n_micro"],
                mesh, gather=True)
            if not with_opt:
                grads, gn = clip_by_global_norm(grads, 1.0)
                return ({"params": grads, "opt": state["opt"]},
                        dict(metrics, grad_norm=gn))
            lr = cosine_schedule(state["opt"]["step"], base_lr=3e-4,
                                 warmup=2000, total=100_000)
            new, gn = _update(grads, state, donate=donate,
                              stacked=tuple(convert._stacks(cfg)), lr=lr,
                              int8_state=opts["int8_opt"])
        return new, dict(metrics, grad_norm=gn, lr=lr)

    b_specs = shard_lib.batch_pspecs(inputs, mesh)
    return BuiltStep(step, (state, inputs), (s_specs, b_specs),
                     (s_specs, None), mesh,
                     donate_argnums=(0,) if donate else (),
                     name=f"{arch_id}:train")


def _serve_params(cfg, family: str = "lm"):
    model = skeleton(cfg, family)
    return model, convert.stack_layers(
        {n: p.detach() for n, p in model.named_parameters()}, cfg)


def make_lm_prefill(cfg: LMConfig, mesh, arch_id: str, inputs) -> BuiltStep:
    """Dense archs prefill on the TP serving layout, MoE archs on the
    training layout (the reference's measured choice; the decode fleet
    always keeps weights stationary)."""
    prefill_mode = "train" if cfg.moe is not None else "serve"
    model, params = _serve_params(cfg)

    def step(params, tokens):
        with moe_constraints(cfg, mesh, mode=prefill_mode), \
                bound(model, params, cfg,
                      gather=mesh if prefill_mode == "train" else None):
            return transformer.prefill(model, cfg, tokens)

    p_specs = shard_lib.param_pspecs(params, mesh, "lm", mode=prefill_mode)
    b_specs = shard_lib.batch_pspecs(inputs["tokens"], mesh)
    return BuiltStep(step, (params, inputs["tokens"]), (p_specs, b_specs),
                     None, mesh, name=f"{arch_id}:prefill")


def make_lm_decode(cfg: LMConfig, mesh, arch_id: str, inputs) -> BuiltStep:
    B = inputs["token"].shape[0]
    model, params = _serve_params(cfg)

    def step(params, token, cache, pos):
        with moe_constraints(cfg, mesh, mode="decode"), \
                bound(model, params, cfg):
            return transformer.decode_step(model, cfg, token, cache, int(pos))

    p_specs = shard_lib.param_pspecs(params, mesh, "lm", mode="serve")
    t_specs = shard_lib.batch_pspecs(inputs["token"], mesh)
    c_specs = shard_lib.cache_pspecs(inputs["cache"], mesh, B)
    return BuiltStep(step, (params, inputs["token"], inputs["cache"], 0),
                     (p_specs, t_specs, c_specs, None),
                     (None, c_specs), mesh, donate_argnums=(2,),
                     name=f"{arch_id}:decode")


# --------------------------------------------------------------- GNN steps


def make_gnn_train(cfg: GNNConfig, mesh, arch_id: str,
                   cell: CellSpec) -> BuiltStep:
    meta = cell.meta
    kind = cell.step
    model = skeleton(cfg, "gnn")

    def loss_fn(m, b):
        if kind == "train_full":
            return gnn_lib.node_loss(m, cfg, b)
        if kind == "train_blocks":
            _, blocks_meta = gnn_lib.block_static_shapes(meta["batch_nodes"],
                                                         meta["fanout"])
            blocks = [dict(blk, n_dst=bm["n_dst"])
                      for blk, bm in zip(b["blocks"], blocks_meta)]
            return gnn_lib.block_loss(m, cfg, {"feats": b["feats"],
                                               "blocks": blocks,
                                               "labels": b["labels"]})
        return gnn_lib.graph_loss(m, cfg, dict(b, n_graphs=meta["batch"]))

    def step(state, batch):
        (loss_v, metrics), grads = _value_and_grad(
            loss_fn, model, state["params"], cfg, batch, mesh, gather=False)
        new, gn = _update(grads, state, donate=True, lr=1e-3)
        return new, dict(metrics, grad_norm=gn)

    state = abstract_state(cfg, "gnn", int8_opt=False)
    s_specs = state_pspecs(state, mesh, "gnn")
    b_specs = shard_lib.gnn_batch_pspecs(cell.inputs, mesh)
    return BuiltStep(step, (state, cell.inputs), (s_specs, b_specs),
                     (s_specs, None), mesh, donate_argnums=(0,),
                     name=f"{arch_id}:{kind}")


# --------------------------------------------------------------- recsys steps


def make_recsys_train(cfg: RecsysConfig, mesh, arch_id: str,
                      inputs) -> BuiltStep:
    model = skeleton(cfg, "recsys")

    def step(state, batch):
        (loss_v, metrics), grads = _value_and_grad(
            lambda m, b: rec_lib.loss_fn(m, cfg, b), model, state["params"],
            cfg, batch, mesh, gather=False)
        new, gn = _update(grads, state, donate=True, lr=1e-3,
                          weight_decay=1e-5)
        return new, dict(metrics, grad_norm=gn)

    state = abstract_state(cfg, "recsys", int8_opt=False)
    s_specs = state_pspecs(state, mesh, "recsys")
    b_specs = shard_lib.batch_pspecs(inputs, mesh)
    return BuiltStep(step, (state, inputs), (s_specs, b_specs),
                     (s_specs, None), mesh, donate_argnums=(0,),
                     name=f"{arch_id}:train")


SERVE_K = 100


def make_recsys_serve(cfg: RecsysConfig, mesh, arch_id: str,
                      inputs) -> BuiltStep:
    """sasrec: users split over the data axes, items over "model", a local
    top-k (the ``topk_distance`` kernel on a CUDA shard) and the
    k-survivor merge (``two_level_search``): the full (B, n_items) score
    matrix never exists. Other kinds: the click model's forward."""
    model, params = _serve_params(cfg, "recsys")

    def step(params, batch):
        with torch.no_grad(), bound(model, params, cfg):
            if cfg.kind == "sasrec":
                from repro_torch.core.distributed import two_level_search
                u = rec_lib.sasrec_user_vector(model, cfg, batch["seq"])
                items = model.item_embed.float()
                return two_level_search(
                    items, u, mesh=mesh, k=SERVE_K, q_axes=batch_axes(mesh),
                    c_axes=("model",), n_valid=cfg.n_items + 1)
            return rec_lib.forward(model, cfg, batch)

    p_specs = shard_lib.param_pspecs(params, mesh, "recsys")
    b_specs = shard_lib.batch_pspecs(inputs, mesh)
    return BuiltStep(step, (params, inputs), (p_specs, b_specs), None, mesh,
                     name=f"{arch_id}:serve")


def make_recsys_retrieval(cfg: RecsysConfig, mesh, arch_id: str,
                          inputs) -> BuiltStep:
    """1 query against 10^6 candidates: the user tower, then exact MIPS
    over the candidate corpus row-sharded over the whole mesh: the
    reference's einsum (``torch.matmul``) and ``lax.top_k``
    (``distances.topk_scores``, the same order), DTensor choosing the
    collectives."""
    all_axes = axis_names(mesh)
    item_field = 0
    model, params = _serve_params(cfg, "recsys")

    def step(params, batch):
        with torch.no_grad(), bound(model, params, cfg):
            cand = with_sharding_constraint(batch["candidates"], mesh,
                                            P(all_axes, None))
            if cfg.kind == "sasrec":
                q = rec_lib.sasrec_user_vector(model, cfg, batch["seq"])
            elif cfg.kind == "autoint":
                q = rec_lib.autoint_user_vector(model, cfg, batch, item_field)
            else:  # fm / deepfm: exact MIPS decomposition [sum_v ; 1]
                q = rec_lib.fm_user_vector(model, cfg, batch, item_field)
            with strict_fp32():
                scores = torch.matmul(q.float(), cand.float().T)
            return D.topk_scores(scores, SERVE_K)

    p_specs = shard_lib.param_pspecs(params, mesh, "recsys")
    b_specs = shard_lib.batch_pspecs(inputs, mesh)
    b_specs = dict(b_specs, candidates=P(all_axes, None))
    return BuiltStep(step, (params, inputs), (p_specs, b_specs), None, mesh,
                     name=f"{arch_id}:retrieval")


# --------------------------------------------------------------- dispatcher


def build_cell_program(cell: CellSpec, mesh, opts=None) -> BuiltStep:
    """The cell's program; ``opts`` overrides an LM train cell's
    ``train_options``."""
    fam, step = cell.family, cell.step
    if fam in ("lm", "encoder"):
        if step == "train":
            return make_lm_train(cell.cfg, mesh, cell.arch_id, cell.inputs,
                                 family=fam, opts=opts)
        if step == "prefill":
            return make_lm_prefill(cell.cfg, mesh, cell.arch_id, cell.inputs)
        return make_lm_decode(cell.cfg, mesh, cell.arch_id, cell.inputs)
    if fam == "gnn":
        return make_gnn_train(cell.cfg, mesh, cell.arch_id, cell)
    if fam == "recsys":
        if step == "train":
            return make_recsys_train(cell.cfg, mesh, cell.arch_id, cell.inputs)
        if step == "retrieval":
            return make_recsys_retrieval(cell.cfg, mesh, cell.arch_id,
                                         cell.inputs)
        return make_recsys_serve(cell.cfg, mesh, cell.arch_id, cell.inputs)
    raise ValueError(f"no program for {fam}:{step}")
