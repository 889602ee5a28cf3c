"""Multi-pod dry run: trace every (arch x shape x mesh) cell on fake ranks
(port of ``repro.launch.dryrun``).

Proves the distribution config is coherent without hardware. The
``"fake"`` process-group backend stands in for 256 (one pod) or 512 ranks
(two pods), this process being rank 0, and ``FakeTensorMode`` makes every
tensor a shape and dtype with no storage: each cell's ``BuiltStep`` runs
once, eagerly, on fake DTensors, and nothing is allocated and no card is
touched. Fake tensors are CPU tensors, so the trace takes the plain
versions of the kernels, as the reference lowers for placeholder CPU
devices. For rank 0 it records:

  - memory: argument and output bytes (the local shards), and the peak of
    the bytes held by live storages that the step's ops made (a storage
    counts from the op that made it until the last tensor on it is freed,
    as PyTorch's caching allocator would hold it, the autograd graph's
    saved tensors included): peak = arguments + that peak, temp = peak -
    arguments - outputs;
  - cost: FLOPs of the LOCAL ops (``torch.utils.flop_counter``'s formulas
    over the shards' shapes: per rank, as XLA's per-device cost_analysis),
    and bytes accessed, each local op's input and output bytes (views
    excluded), the unfused upper bound like XLA's "bytes accessed";
  - collectives by the reference's five kinds: count and result bytes a
    rank receives, and those bytes by the mesh axis each ran over. A
    ``Shard(i)`` -> ``Shard(j)`` redistribute is one all-to-all of the
    shard, as NCCL runs it: on a CPU mesh DTensor would all-gather the
    whole tensor and keep a chunk (gloo has no all-to-all), so for the
    trace ``LocalCost`` has it issue ``all_to_all_single`` on the fake
    group instead (``_shard_dim_alltoall``). Each collective's bytes are
    also kept by the site that issued it (``collective_sites``): the
    innermost frame of the port's code, the PyTorch function it called,
    the DTensor op being run and the collective's result shape;
  - the peak's parts (``memory["peak_breakdown"]``, summing to the peak):
    the arguments by top-level key, and the live storages by the op and
    site that made each.

It writes one JSON per cell, as the reference does.

Usage:
  python -m repro_torch.launch.dryrun --arch stablelm-1.6b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--out DIR]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

_KIND = {"all_gather_into_tensor": "all-gather",
         "all_gather_into_tensor_coalesced": "all-gather",
         "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
         "reduce_scatter_tensor": "reduce-scatter",
         "reduce_scatter_tensor_coalesced": "reduce-scatter",
         "all_to_all_single": "all-to-all",
         "broadcast": "collective-permute"}


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


class LocalCost(TorchDispatchMode):
    """Counts what the local ops of a trace cost (see the module's
    docstring). DTensor-level ops pass through (``NotImplemented``):
    DTensor runs them and their local ops come back here. Only ops on
    tensors of ``fake_mode`` count, and none that DTensor's sharding
    propagation runs on global shapes to infer an output. ``group_axes``
    maps a process group's name to the mesh axis it spans."""

    def __init__(self, fake_mode, group_axes=None):
        super().__init__()
        self.fake_mode = fake_mode
        self.group_axes = group_axes or {}
        self.sites = {}
        self._dt_op = None
        # the live bytes by the op (and site) that made each storage, and
        # their copy at the peak
        self._by_origin = {}
        self.peak_breakdown = {}
        self.flops = 0
        self.bytes_accessed = 0
        self.collectives = {k: {"count": 0, "bytes": 0, "by_axis": {}}
                            for k in COLLECTIVES}
        self.live = 0
        self.peak = 0
        self._storages = {}

    def _ours(self, tensors) -> bool:
        from torch._subclasses.fake_tensor import FakeTensor
        fakes = [t for t in tensors if isinstance(t, FakeTensor)]
        return all(t.fake_mode is self.fake_mode for t in fakes)

    def __enter__(self):
        # DTensor's sharding propagation infers an op's output on global
        # fake shapes (once a signature, then cached); those ops run under
        # the active fake mode but are no rank's work, so they pause the
        # count
        from torch.distributed.tensor._sharding_prop import ShardingPropagator
        self.paused = 0
        self._infer = ShardingPropagator._propagate_tensor_meta_non_cached
        infer, cost = self._infer, self

        def paused(prop, *a, **kw):
            cost.paused += 1
            try:
                return infer(prop, *a, **kw)
            finally:
                cost.paused -= 1

        ShardingPropagator._propagate_tensor_meta_non_cached = paused
        # a Shard -> Shard redistribute: the all-to-all NCCL would run
        from torch.distributed.tensor import placement_types
        self._a2a = placement_types.shard_dim_alltoall
        placement_types.shard_dim_alltoall = _shard_dim_alltoall
        return super().__enter__()

    def __exit__(self, *exc):
        from torch.distributed.tensor import placement_types
        from torch.distributed.tensor._sharding_prop import ShardingPropagator
        ShardingPropagator._propagate_tensor_meta_non_cached = self._infer
        placement_types.shard_dim_alltoall = self._a2a
        return super().__exit__(*exc)

    def _track(self, t, origin: str) -> None:
        key = t.untyped_storage()._cdata
        entry = self._storages.get(key)
        if entry is None:
            entry = self._storages[key] = [t.untyped_storage().nbytes(), 0,
                                           origin]
            self.live += entry[0]
            self._by_origin[origin] = (self._by_origin.get(origin, 0)
                                       + entry[0])
            if self.live > self.peak:
                self.peak = self.live
                self.peak_breakdown = {
                    k: v for k, v in self._by_origin.items() if v}
        entry[1] += 1
        weakref.finalize(t, self._release, key)

    def _release(self, key) -> None:
        entry = self._storages.get(key)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] == 0:
            self.live -= entry[0]
            self._by_origin[entry[2]] -= entry[0]
            del self._storages[key]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        flat_in = [a for a in tree_flatten((args, kwargs))[0]
                   if isinstance(a, torch.Tensor)]
        if any(isinstance(a, DTensor) for a in flat_in):
            # not a local op: DTensor runs it, and its local ops come back
            # through this mode, which stays on the stack
            self._dt_op = func
            return NotImplemented
        out = func(*args, **kwargs)
        flat_out = [o for o in tree_flatten(out)[0]
                    if isinstance(o, torch.Tensor)]
        if self.paused or not self._ours(flat_in + flat_out):
            return out
        packet = func._overloadpacket
        ns, name = packet._qualified_op_name.split("::")
        if ns == "_c10d_functional" and name in _KIND:
            rec = self.collectives[_KIND[name]]
            n = sum(_nbytes(o) for o in flat_out)
            rec["count"] += 1
            rec["bytes"] += n
            group = args[-1] if isinstance(args[-1], str) else ""
            axis = self.group_axes.get(group, group)
            rec["by_axis"][axis] = rec["by_axis"].get(axis, 0) + n
            shape = "x".join(str(d) for d in flat_out[0].shape)
            key = f"{_KIND[name]} {axis} {_site()} {self._dt_op} {shape}"
            self.sites[key] = self.sites.get(key, 0) + n
        from torch.utils.flop_counter import flop_registry
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs,
                                                     out_val=out))
        is_view = any(r.alias_info is not None for r in func._schema.returns)
        if not is_view and ns == "aten":
            self.bytes_accessed += (sum(_nbytes(t) for t in flat_in)
                                    + sum(_nbytes(t) for t in flat_out))
        if not is_view and flat_out:
            origin = f"{_site()} {packet}"
            for o in flat_out:
                self._track(o, origin)
        return out


def _shard_dim_alltoall(x, gather_dim, shard_dim, mesh, mesh_dim):
    """DTensor's ``shard_dim_alltoall`` as the functional
    ``all_to_all_single`` over the mesh dim's group: x (this rank's shard
    on ``gather_dim``) cut into one piece a peer along ``shard_dim``, the
    pieces exchanged, those received joined along ``gather_dim``."""
    from torch.distributed import _functional_collectives as funcol
    n = mesh.size(mesh_dim)
    send = torch.stack(torch.chunk(x, n, dim=shard_dim))
    got = funcol.all_to_all_single(send, None, None, (mesh, mesh_dim))
    if isinstance(got, funcol.AsyncCollectiveTensor):
        got = got.wait()
    return torch.cat(got.unbind(0), dim=gather_dim).contiguous()


def _site() -> str:
    """The innermost frame of the port's model or step code (the launch
    layer's own frames skipped) and the PyTorch function it called that
    issued the collective: "file:function > callee"; in a backward pass
    the port's frame is the step's ``_value_and_grad`` and the callee the
    backward that the autograd engine ran."""
    import sys
    f, callee = sys._getframe(2), "?"
    while f is not None:
        name = f.f_code.co_filename
        if "repro_torch" in name and "dryrun" not in name:
            return (f"{os.path.basename(name)}:{f.f_code.co_name} > "
                    f"{callee}")
        callee = getattr(f.f_code, "co_qualname", f.f_code.co_name)
        f = f.f_back
    return "?"


@contextlib.contextmanager
def fake_world(world: int):
    """The fake backend at ``world`` ranks, this process rank 0, for the
    block; the group is destroyed after."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("fake_world needs no default process group")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def fake_mesh(shape, names):
    """A ``DeviceMesh`` of ``shape`` on the CPU over the fake group."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(names))


def group_axes(mesh) -> dict:
    """{process group name: mesh axis} for ``LocalCost``."""
    return {mesh.get_group(a).group_name: a for a in mesh.mesh_dim_names}


def smoke_cell(cell, *, seq: int = 64, batch: int = 8):
    """A SMOKE cell cut so that its trace is quick: LM sequences at most
    ``seq`` (the SMOKE configs' 32-wide attention chunks would otherwise
    loop over thousands of blocks) and batches at most ``batch``; the
    other families' shapes are kept (their op count does not grow with
    them)."""
    from repro_torch.launch.shapes import lm_inputs
    if cell.family not in ("lm", "encoder"):
        return cell
    shp = dict(cell.meta, seq_len=min(cell.meta["seq_len"], seq),
               global_batch=min(cell.meta["global_batch"], batch))
    return dataclasses.replace(cell, meta=shp, inputs=lm_inputs(cell.cfg, shp))


def smoke_opts(cell):
    """A SMOKE train cell's options with one micro-batch (each is a trace
    of the whole model: deepseek-v3's 16 would take minutes)."""
    from repro_torch.launch.steps import train_options
    if cell.step != "train" or cell.family not in ("lm", "encoder"):
        return None
    return dict(train_options(cell.arch_id, cell.family), n_micro=1)


def trace(built, mesh) -> dict:
    """Run ``built`` once on fake DTensors under a fresh ``FakeTensorMode``
    and ``LocalCost``; returns the record's memory (with the peak's
    parts), cost and collectives (with their bytes by issuing site)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor
    fake = FakeTensorMode(allow_non_fake_inputs=True)
    with fake:
        args = built.abstract_args()
        arg_bytes = sum(_nbytes(t.to_local()) for t in tree_flatten(args)[0]
                        if isinstance(t, DTensor))
        cost = LocalCost(fake, group_axes(mesh))
        arg_parts = _arg_bytes(args)
        with cost:
            out = built.fn(*args)
        out_bytes = sum(_nbytes(t.to_local() if isinstance(t, DTensor) else t)
                        for t in tree_flatten(out)[0]
                        if isinstance(t, torch.Tensor))
        peak = arg_bytes + cost.peak
    coll = cost.collectives
    parts = dict(arg_parts, **{"made: " + k: v for k, v in
                               cost.peak_breakdown.items()})
    return {
        "memory": {"argument_bytes": int(arg_bytes),
                   "output_bytes": int(out_bytes),
                   "temp_bytes": int(max(peak - arg_bytes - out_bytes, 0)),
                   "peak_bytes": int(peak),
                   "peak_breakdown": dict(sorted(parts.items(),
                                                 key=lambda kv: -kv[1]))},
        "cost": {"flops": float(cost.flops),
                 "bytes_accessed": float(cost.bytes_accessed),
                 "transcendentals": 0.0},
        "collectives": coll,
        "collective_bytes_total": int(sum(v["bytes"] for v in coll.values())),
        "collective_sites": dict(sorted(cost.sites.items(),
                                        key=lambda kv: -kv[1])),
    }


def run_cell(arch_id: str, shape_id: str, *, multi_pod: bool = False,
             mesh=None, smoke: bool = False, verbose: bool = True) -> dict:
    """One cell's record. ``mesh`` None builds the production mesh over
    the fake group that the caller set up (``fake_world``); ``smoke``
    traces the SMOKE config of the cell (``smoke_cell``)."""
    from repro_torch.launch.mesh import make_production_mesh, mesh_shape
    from repro_torch.launch.shapes import cell_is_skipped, get_cell
    from repro_torch.launch.steps import build_cell_program

    skip = cell_is_skipped(arch_id, shape_id)
    if skip:
        return {"arch": arch_id, "shape": shape_id, "status": "skipped",
                "reason": skip}
    t0 = time.time()
    mesh = mesh if mesh is not None else make_production_mesh(
        multi_pod=multi_pod)
    cell = get_cell(arch_id, shape_id, smoke=smoke)
    opts = None
    if smoke:
        cell = smoke_cell(cell)
        opts = smoke_opts(cell)
    built = build_cell_program(cell, mesh, opts=opts)
    t_build = time.time() - t0
    rec = trace(built, mesh)
    t_trace = time.time() - t0 - t_build
    rec = {"arch": arch_id, "shape": shape_id, "status": "ok",
           "mesh": {"shape": mesh_shape(mesh), "n_devices": int(mesh.size()),
                    "multi_pod": multi_pod},
           "step": built.name, "smoke": smoke,
           "build_s": round(t_build, 2), "trace_s": round(t_trace, 2),
           **rec}
    if verbose:
        m = rec["memory"]
        print(f"[{arch_id} x {shape_id}] {'2-pod' if multi_pod else '1-pod'} "
              f"ok: trace {t_trace:.1f}s | args/rank "
              f"{m['argument_bytes'] / 2**30:.2f} GiB peak/rank "
              f"{m['peak_bytes'] / 2**30:.2f} GiB | GFLOPs "
              f"{rec['cost']['flops'] / 1e9:.1f} coll "
              f"{rec['collective_bytes_total'] / 2**20:.1f} MiB", flush=True)
    return rec


def _arg_bytes(args) -> dict:
    """A step's arguments' local bytes by part: "args: params",
    "args: opt" (the moments), "args: batch", ... (the top-level keys of a
    state or batch tree)."""
    from torch.distributed.tensor import DTensor
    out = {}
    for i, tree in enumerate(args):
        for name, leaf in _named_leaves(tree):
            if isinstance(leaf, DTensor):
                part = f"args: {name.split('.')[0] if i == 0 else 'input'}"
                out[part] = out.get(part, 0) + _nbytes(leaf.to_local())
    return out


def _named_leaves(tree):
    from repro_torch.launch.sharding import leaves
    return leaves(tree) if isinstance(tree, (dict, list, tuple)) else [
        ("", tree)]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)

    from repro_torch.launch.shapes import all_cells

    torch.set_num_threads(min(4, os.cpu_count() or 1))
    cells = (all_cells(include_skipped=True) if args.all
             else [(args.arch, args.shape)])
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    os.makedirs(args.out, exist_ok=True)
    failures = []
    for mp in meshes:
        with fake_world(512 if mp else 256):
            for arch_id, shape_id in cells:
                tag = f"{arch_id}__{shape_id}__{'pod2' if mp else 'pod1'}"
                path = os.path.join(args.out, tag + ".json")
                if os.path.exists(path):
                    print(f"[{tag}] cached")
                    continue
                try:
                    rec = run_cell(arch_id, shape_id, multi_pod=mp)
                except Exception as e:  # a failure here is a sharding bug
                    traceback.print_exc()
                    rec = {"arch": arch_id, "shape": shape_id,
                           "status": "error", "multi_pod": mp,
                           "error": f"{type(e).__name__}: {e}"}
                    failures.append(tag)
                with open(path, "w") as fh:
                    json.dump(rec, fh, indent=1)
    if failures:
        print(f"\nFAILED cells: {failures}")
        raise SystemExit(1)
    print("\nall requested cells traced OK")


if __name__ == "__main__":
    main()
