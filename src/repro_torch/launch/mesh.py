"""Production meshes over ``torch.distributed`` (port of
``repro.launch.mesh``).

Single pod: (16, 16) ("data", "model") over 256 ranks.
Multi-pod:  (2, 16, 16) ("pod", "data", "model") over 512 ranks.

The shapes are the reference's, so that every sharding spec compares with
its own cell by cell. On H100s a rank is one card: a 16-wide "model" axis
spans two 8-GPU NVLink nodes, so its collectives cross InfiniBand
(``launch.roofline`` prices it so), and the "data" and "pod" axes cross
nodes too.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the default
process group, which the caller initializes: NCCL on the cards, ``gloo``
on the CPU, or the ``"fake"`` backend (``launch.dryrun``) that stands in
for 256 or 512 ranks in one process. Every helper here also takes an
``AbstractMesh`` (axis names and sizes only, the port's
``jax.sharding.AbstractMesh``), which is all the sharding rules read.

Functions, not module constants: importing this module touches no process
group and no device.
"""
from __future__ import annotations

import math
import os

import torch
import torch.distributed as dist


class AbstractMesh:
    """Axis names and sizes, no devices: ``shape`` {axis: size} in axis
    order, ``axis_names``."""

    def __init__(self, shape, axis_names):
        shape = tuple(int(s) for s in shape)
        names = tuple(axis_names)
        if len(shape) != len(names) or len(set(names)) != len(names):
            raise ValueError(f"mesh {shape} needs {len(shape)} distinct "
                             f"axis names, got {names}")
        self.axis_names = names
        self.shape = dict(zip(names, shape))

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def __repr__(self) -> str:
        return f"AbstractMesh({self.shape})"


def axis_names(mesh) -> tuple:
    """The mesh's axis names, in order (a ``DeviceMesh``'s
    ``mesh_dim_names``)."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def mesh_shape(mesh) -> dict:
    """{axis: size} in axis order, for a ``DeviceMesh`` or an
    ``AbstractMesh``."""
    if getattr(mesh, "mesh_dim_names", None) is not None:
        return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    return dict(mesh.shape)


def _default_group(backend: str) -> None:
    """Initialize the default process group when there is none: from the
    launcher's environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``) when it is set, else a group of one rank over an
    in-process store."""
    if dist.is_initialized():
        return
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)


def _mesh_device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_production_mesh(*, multi_pod: bool = False):
    """The (16, 16) or (2, 16, 16) mesh over the default group, which must
    hold 256 or 512 ranks (NCCL on cards, or the fake backend)."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if not dist.is_initialized():
        raise RuntimeError("make_production_mesh needs an initialized "
                           "default process group of 256 or 512 ranks")
    world = dist.get_world_size()
    if world != math.prod(shape):
        raise RuntimeError(f"a {shape} mesh needs {math.prod(shape)} ranks, "
                           f"the default group has {world}")
    return init_device_mesh(_mesh_device_type(), shape, mesh_dim_names=axes)


def make_host_mesh(device_type=None):
    """Every rank of the world as a 1-axis "data" mesh (examples, tests).
    ``None`` means the CUDA cards over NCCL and raises without a card;
    ``"cpu"`` is ``gloo`` (the tests). The default group is initialized
    when there is none (``_default_group``)."""
    from torch.distributed.device_mesh import init_device_mesh
    if device_type is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_host_mesh: no CUDA device; pass "
                               "device_type='cpu' for a gloo mesh")
        device_type = "cuda"
    _default_group("nccl" if device_type == "cuda" else "gloo")
    return init_device_mesh(device_type, (dist.get_world_size(),),
                            mesh_dim_names=("data",))


def batch_axes(mesh) -> tuple:
    """Axes the global batch shards over (everything except "model")."""
    return tuple(a for a in axis_names(mesh) if a != "model")


def fsdp_axes(mesh) -> tuple:
    """Axes parameters/optimizer shard over in the FSDP dimension."""
    return batch_axes(mesh)


def axis_size(mesh, axes) -> int:
    shape = mesh_shape(mesh)
    n = 1
    for a in axes:
        n *= shape[a]
    return n
