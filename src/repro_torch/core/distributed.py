"""Search over a mesh of devices: corpus rows sharded, queries replicated
(port of ``repro.core.distributed``).

The reference runs one SPMD program under ``shard_map``: every device
scores the replicated queries against its rows, lifts its local ids to
global ones by its row offset, and the (Q, k) winners of every device are
all-gathered and merged by one more top-k, the only collective of the
query path. A hierarchical variant merges within each inner-axis group
first, so that only k survivors a group cross the outer axis.

The port keeps the reference's single controller. A ``Mesh`` is a grid of
``torch.device`` with named axes; a row-sharded array (``ShardedRows``)
holds one slab a shard, on the shard's device, in flattened mesh order
(row-major over the sharded axes); each shard's local search launches the
shard's kernels (``topk_distance``, ``pq_adc``, the ``ivf_adc`` grids) on
its slab, and the all-gather is a copy of each shard's (Q, k) candidates
to the merge device (``devices.flat[0]``), followed by the merge there.
Results are replicated, so they come back on the merge device.

A mesh may repeat a device: ``make_mesh((4,), ("data",),
devices=["cuda:0"] * 4)`` gives four logical shards on one card, the
counterpart of the reference tests' host-platform device count. Slabs,
id lifting, pad rows, pad blocks and the merge then all run, one shard
after another; what such a mesh cannot show is an interconnect.

Every merge is a stable descending sort over the shard-major
concatenation of the candidates, the order ``lax.top_k`` gives over a
tiled ``all_gather``: between equal scores the lower shard wins, then the
lower slot. Slots past a shard's candidates are (-inf, -1), and ids come
back as int64. The reference's ``tile`` arguments (its scan tiles) are
taken at their defaults only: the kernels pick their own tiles
(``kernels.topk_distance.plan``), so another value would change nothing.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core import distances as D
from repro_torch.core.flat import flat_search
from repro_torch.kernels import ops as kops


class PartitionSpec:
    """A leaf's placement, one entry a dimension: a mesh axis name, a tuple
    of names (sharded over their flattened product) or None (whole); the
    port's ``jax.sharding.PartitionSpec``. ``checkpoint.save(pspecs=)``
    records it in the reference's manifest form."""

    def __init__(self, *entries):
        self.entries = tuple(tuple(e) if isinstance(e, list) else e
                             for e in entries)

    def __iter__(self):
        return iter(self.entries)

    def __eq__(self, other) -> bool:
        return (isinstance(other, PartitionSpec)
                and self.entries == other.entries)

    def __hash__(self) -> int:
        return hash(self.entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{self.entries}"


P = PartitionSpec


class Mesh:
    """A grid of devices with named axes (the port's ``jax.sharding.Mesh``):
    ``devices`` an ndarray of ``torch.device``, ``shape`` {axis: size} in
    axis order. The merge device, where results are gathered, is
    ``devices.flat[0]``."""

    def __init__(self, devices, axis_names):
        arr = np.asarray(devices, dtype=object)
        names = tuple(axis_names)
        if arr.ndim != len(names) or len(set(names)) != len(names):
            raise ValueError(f"mesh of shape {arr.shape} needs {arr.ndim} "
                             f"distinct axis names, got {names}")
        self.devices = np.empty(arr.shape, dtype=object)
        for idx in np.ndindex(arr.shape):
            self.devices[idx] = torch.device(arr[idx])
        self.axis_names = names
        self.shape = dict(zip(names, arr.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def merge_device(self) -> torch.device:
        return self.devices.flat[0]

    def _axes(self, axes) -> tuple:
        axes = self.axis_names if axes is None else tuple(axes)
        unknown = [a for a in axes if a not in self.shape]
        if unknown:
            raise ValueError(f"axes {unknown} not in mesh {self.axis_names}")
        return axes

    def shard_devices(self, axes=None) -> list:
        """The device of each shard of rows split over ``axes``, in
        flattened order (row-major over ``axes``); every other axis at
        index 0 (a slab is replicated along the axes it is not split
        over, and one copy is searched)."""
        axes = self._axes(axes)
        sizes = [self.shape[a] for a in axes]
        out = []
        for flat_idx in range(math.prod(sizes)):
            coord = dict(zip(axes, np.unravel_index(flat_idx, sizes)))
            out.append(self.devices[tuple(int(coord.get(a, 0))
                                          for a in self.axis_names)])
        return out

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, devices="
                f"{[str(d) for d in self.devices.flat]})")


def make_mesh(axis_shapes, axis_names, devices=None) -> Mesh:
    """The port's ``jax.make_mesh``: a mesh of ``axis_shapes`` over the
    first prod(axis_shapes) of ``devices``. None takes every CUDA card in
    order and raises when there are fewer than the shape needs (it never
    falls back to the CPU); an explicit list may repeat a device
    (``["cuda:0"] * 4``, ``["cpu"] * 8``)."""
    shape = tuple(int(s) for s in axis_shapes)
    n = math.prod(shape)
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if count < n:
            raise RuntimeError(
                f"a mesh of shape {shape} needs {n} CUDA cards, found "
                f"{count}; pass devices=[...] to repeat a device (a card, or "
                "'cpu' for the plain PyTorch versions)")
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = [torch.device(d) for d in devices]
    if len(devices) < n:
        raise ValueError(f"a mesh of shape {shape} needs {n} devices, got "
                         f"{len(devices)}")
    arr = np.empty(n, dtype=object)
    arr[:] = devices[:n]
    return Mesh(arr.reshape(shape), axis_names)


class NamedSharding:
    """``spec`` over ``mesh`` (the port's ``jax.sharding.NamedSharding``).
    The port shards rows only: the first entry names the axes the rows
    split over, any later entry is None; an empty spec or a None first
    entry replicates."""

    def __init__(self, mesh: Mesh, spec: PartitionSpec):
        entries = tuple(spec)
        if any(e is not None for e in entries[1:]):
            raise ValueError(f"{spec}: the port shards the first dimension "
                             "only")
        first = entries[0] if entries else None
        axes = () if first is None else (
            (first,) if isinstance(first, str) else tuple(first))
        self.mesh = mesh
        self.spec = spec
        self.axes = mesh._axes(axes) if axes else ()
        self.n_shards = math.prod(mesh.shape[a] for a in self.axes)
        self.devices = mesh.shard_devices(self.axes)

    def place(self, x):
        """``x`` placed: a ``ShardedRows`` of its row slabs (the rows must
        divide the shard count, as ``device_put`` requires), or for a
        replicated spec the tensor on the merge device."""
        x = torch.as_tensor(x)
        if not self.axes:
            return x.to(self.mesh.merge_device)
        if x.dim() == 0 or x.shape[0] % self.n_shards:
            raise ValueError(f"{tuple(x.shape)} rows do not split into "
                             f"{self.n_shards} shards (pad_to_shards)")
        return ShardedRows([part.to(dev) for part, dev in
                            zip(x.chunk(self.n_shards), self.devices)], self)


class ShardedRows:
    """A row-sharded array: ``shards[i]`` holds rows [i * local_n,
    (i + 1) * local_n) of the logical array, on ``sharding.devices[i]``."""

    def __init__(self, shards, sharding: NamedSharding):
        if len(shards) != sharding.n_shards:
            raise ValueError(f"{len(shards)} slabs for {sharding.n_shards} "
                             "shards")
        self.shards = list(shards)
        self.sharding = sharding

    @property
    def local_n(self) -> int:
        return self.shards[0].shape[0]

    @property
    def shape(self) -> tuple:
        return ((self.local_n * len(self.shards),)
                + tuple(self.shards[0].shape[1:]))

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    def numel(self) -> int:
        return sum(s.numel() for s in self.shards)

    def gather(self) -> torch.Tensor:
        """The logical array on the merge device."""
        dev = self.sharding.mesh.merge_device
        return torch.cat([s.to(dev) for s in self.shards])


def corpus_sharding(mesh: Mesh, axes=None) -> NamedSharding:
    """Row sharding over ``axes`` (every mesh axis by default, flattened)."""
    return NamedSharding(mesh, P(mesh._axes(axes), None))


def _as_sharded(x, sharding: NamedSharding) -> ShardedRows:
    return x if isinstance(x, ShardedRows) else sharding.place(x)


def pad_to_shards(x, n_shards: int):
    """Pad rows to a multiple of n_shards with zero rows; returns (padded,
    valid mask)."""
    N = x.shape[0]
    pad = (-N) % n_shards
    valid = torch.arange(N + pad, device=x.device) < N
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
    return x, valid


def _merge(parts, k: int):
    """One top-k over the candidate sets side by side, ties to the lower
    position, on the first set's device."""
    dev = parts[0][0].device
    s = torch.cat([p[0].to(dev) for p in parts], dim=1)
    i = torch.cat([p[1].to(dev) for p in parts], dim=1)
    top, pos = D.topk_scores(s, k)
    return top, torch.gather(i, 1, pos)


def _merge_local_topk(parts, *, k: int, sizes, hierarchical: bool, device):
    """The shared merge tail: pad each shard's (Q, k') candidates to k with
    (-inf, -1); with ``hierarchical`` and more than one axis, merge within
    each group along the innermost axis, then the next one out (the
    reference's ``for a in reversed(axes[1:])``), each group on its first
    shard's device; then gather along the outer axis onto ``device`` and
    merge. ``parts`` is in flattened shard order over axes of ``sizes``."""
    parts = [D.pad_to_k(s, i, k) for s, i in parts]
    if hierarchical and len(sizes) > 1:
        for n in reversed(sizes[1:]):
            parts = [_merge(parts[g:g + n], k)
                     for g in range(0, len(parts), n)]
    return _merge([(s.to(device), i.to(device)) for s, i in parts], k)


def check_tile(tile: int, default: int) -> None:
    """Refuse a ``tile`` other than the reference's default (see above)."""
    if tile != default:
        raise ValueError(f"tile={tile}: the port's kernels pick their own "
                         f"tiles; only the reference's default {default} "
                         "is taken")


def _lift(s, i, base: int):
    """Local ids to global ones (int64), knocked-out slots kept at -1."""
    i = i.long()
    return s, torch.where(i >= 0, i + base, -1)


def sharded_flat_search(corpus, q, *, mesh: Mesh, k: int,
                        metric: str = "cosine", axes=None, valid=None,
                        tile: int = 65536, hierarchical: bool = True,
                        corpus_sq=None, use_kernel=None):
    """Exact distributed top-k: ``corpus`` (N, d) row-sharded (a
    ``ShardedRows``, or a tensor placed by ``corpus_sharding``); q (Q, d)
    replicated. Each shard runs ``flat_search`` (the ``topk_distance``
    kernel on a CUDA slab) at k' = min(k, local_n). ``valid`` and
    ``corpus_sq`` (|c|^2 for l2; recomputed a call when None, as the
    reference does) are sharded like the corpus. N must divide the shard
    count (``pad_to_shards``). Returns (scores (Q, k), global ids (Q, k)
    int64) on the merge device."""
    check_tile(tile, 65536)
    sh = corpus_sharding(mesh, axes)
    corpus = _as_sharded(corpus, sh)
    valid = None if valid is None else _as_sharded(valid, sh)
    sq = None if corpus_sq is None else _as_sharded(corpus_sq, sh)
    local_n = corpus.local_n
    parts = []
    for idx, (c_blk, dev) in enumerate(zip(corpus.shards, sh.devices)):
        s, i = flat_search(c_blk, q.to(dev), metric=metric,
                           k=min(k, local_n),
                           corpus_sq=None if sq is None else sq.shards[idx],
                           valid=None if valid is None else valid.shards[idx],
                           use_kernel=use_kernel)
        parts.append(_lift(s, i, idx * local_n))
    return _merge_local_topk(parts, k=k,
                             sizes=[mesh.shape[a] for a in sh.axes],
                             hierarchical=hierarchical,
                             device=mesh.merge_device)


def sharded_pq_search(codes, luts, *, mesh: Mesh, k: int, axes=None,
                      valid=None, hierarchical: bool = True, use_kernel=None,
                      lut_dtype: str = "float32"):
    """Compressed distributed top-k: PQ codes (N, m) row-sharded, the
    (Q, m, ksub) LUTs replicated. Each shard runs ``kops.adc_topk`` (the
    ``pq_adc`` kernel on a CUDA slab) over its N/S codes, then the same
    lift and merge as ``sharded_flat_search``. Per-device resident bytes
    are N*m/S plus the replicated tables. Returns (scores (Q, k), global
    ids (Q, k) int64)."""
    sh = corpus_sharding(mesh, axes)
    codes = _as_sharded(codes, sh)
    valid = None if valid is None else _as_sharded(valid, sh)
    local_n = codes.local_n
    parts = []
    for idx, (c_blk, dev) in enumerate(zip(codes.shards, sh.devices)):
        s, i = kops.adc_topk(c_blk, luts.to(dev), k=min(k, local_n),
                             valid=None if valid is None else valid.shards[idx],
                             use_kernel=use_kernel, lut_dtype=lut_dtype)
        parts.append(_lift(s, i, idx * local_n))
    return _merge_local_topk(parts, k=k,
                             sizes=[mesh.shape[a] for a in sh.axes],
                             hierarchical=hierarchical,
                             device=mesh.merge_device)


def local_visit(visit, idx: int, blocks_per_shard: int):
    """Shard ``idx``'s view of a global visit table: the steps on its
    block range [idx * bps, (idx + 1) * bps) localized to its slab, every
    other step (off-shard probes and the -1 tails) retargeted at its pad
    block ``bps``."""
    off = idx * blocks_per_shard
    inside = (visit >= off) & (visit < off + blocks_per_shard)
    return torch.where(inside, visit - off, blocks_per_shard).to(torch.int32)


def sharded_ivf_pq_search(bucket_codes, bucket_ids, visit, luts, coarse, *,
                          mesh: Mesh, k: int, steps_per_probe: int = 1,
                          blocks_per_shard: int, axes=None,
                          hierarchical: bool = True, use_kernel=None,
                          lut_dtype: str = "float32"):
    """Bucket-range-sharded IVF-PQ top-k: each shard owns a contiguous
    range of inverted-list blocks plus its own all-pad block; the visit
    table, LUTs and coarse terms are replicated.

    ``visit`` (Q, T) numbers blocks globally in [0, S * blocks_per_shard),
    with the tails of short clusters at -1. Each shard localizes it
    (``local_visit``) and runs ``kops.ivf_adc_topk`` (the ``ivf_adc`` grids
    on a CUDA slab, ``auto`` dispatch) with ``pad_block=blocks_per_shard``,
    so that the per-query grid skips the steps that are not its own (the
    reference passes no pad block: its shards score every step, most of
    them on the pad block; the answers are the same). Bucket ids hold
    global rows, so nothing is lifted.

    bucket_codes: (S * (blocks_per_shard + 1), blk, m) and bucket_ids
    likewise (``ShardedRows`` or tensors); luts (Q, m, ksub) or (Q,
    nprobe, m, ksub); coarse (Q, nprobe) f32. Returns (scores (Q, k), ids
    (Q, k) int64)."""
    sh = corpus_sharding(mesh, axes)
    codes = _as_sharded(bucket_codes, sh)
    ids = _as_sharded(bucket_ids, sh)
    if codes.shape[0] != sh.n_shards * (blocks_per_shard + 1):
        raise ValueError(f"bucket_codes {codes.shape} is not {sh.n_shards} "
                         f"slabs of {blocks_per_shard} + 1 blocks")
    kk = min(k, (blocks_per_shard + 1) * codes.shape[1])
    parts = []
    for idx, (c_blk, id_blk, dev) in enumerate(
            zip(codes.shards, ids.shards, sh.devices)):
        s, i = kops.ivf_adc_topk(
            c_blk, id_blk, local_visit(visit.to(dev), idx, blocks_per_shard),
            luts.to(dev), k=kk, coarse=coarse.to(dev),
            steps_per_probe=steps_per_probe, use_kernel=use_kernel,
            lut_dtype=lut_dtype, pad_block=blocks_per_shard)
        parts.append((s, i.long()))
    return _merge_local_topk(parts, k=k,
                             sizes=[mesh.shape[a] for a in sh.axes],
                             hierarchical=hierarchical,
                             device=mesh.merge_device)


def two_level_search(corpus, q, *, mesh: Mesh, k: int, q_axes, c_axes,
                     tile: int = 4096, n_valid: int = None,
                     metric: str = "dot"):
    """Batched distributed top-k: queries sharded over ``q_axes``, corpus
    rows over ``c_axes`` (disjoint). Each (query block, corpus slab) pair
    runs ``flat_search`` (the ``topk_distance`` kernel) on the slab's
    device, rows at or past ``n_valid`` knocked out; the k survivors of
    each slab merge across ``c_axes`` in one step. Q must divide the query
    shard count and N the corpus shard count. Returns (scores (Q, k), ids
    (Q, k) int64) on the merge device, query blocks in order. With a
    ``DeviceMesh`` (``launch.mesh``) every rank searches its own shards and
    the results are DTensors sharded over ``q_axes``
    (``_two_level_device_mesh``)."""
    check_tile(tile, 4096)
    if is_device_mesh(mesh):
        return _two_level_device_mesh(corpus, q, mesh=mesh, k=k,
                                      q_axes=tuple(q_axes),
                                      c_axes=tuple(c_axes), n_valid=n_valid,
                                      metric=metric)
    q_sh = NamedSharding(mesh, P(tuple(q_axes), None))
    c_sh = NamedSharding(mesh, P(tuple(c_axes), None))
    if set(q_sh.axes) & set(c_sh.axes):
        raise ValueError(f"q_axes {q_sh.axes} and c_axes {c_sh.axes} overlap")
    corpus = _as_sharded(corpus, c_sh)
    if q.shape[0] % q_sh.n_shards:
        raise ValueError(f"{q.shape[0]} queries do not split into "
                         f"{q_sh.n_shards} shards")
    local_n = corpus.local_n
    kk = min(k, local_n)
    out = []
    for q_blk in q.chunk(q_sh.n_shards):
        parts = []
        for idx, (c_blk, dev) in enumerate(zip(corpus.shards, c_sh.devices)):
            base = idx * local_n
            valid = (None if n_valid is None else
                     base + torch.arange(local_n, device=dev) < n_valid)
            s, i = flat_search(c_blk, q_blk.to(dev), metric=metric, k=kk,
                               valid=valid)
            parts.append(_lift(s, i, base))
        out.append(_merge_local_topk(parts, k=k, sizes=[len(parts)],
                                     hierarchical=False,
                                     device=mesh.merge_device))
    return (torch.cat([s for s, _ in out]), torch.cat([i for _, i in out]))


# ------------------------------------------------- torch.distributed meshes
#
# The functions below take a ``DeviceMesh`` over a process group (one rank
# a device: NCCL on the cards, gloo on the CPU, the fake backend in the dry
# run) and DTensors, the port's SPMD idiom (``launch.mesh``): every rank
# runs the same program on its own shards, and the collectives cross ranks.


def contiguous_stride(shape) -> tuple:
    """The strides of a contiguous tensor of ``shape`` (a DTensor's global
    stride, computed without making a tensor: under ``FakeTensorMode`` even
    a ``meta`` one would count as an allocation of the whole)."""
    stride, acc = [], 1
    for s in reversed(tuple(shape)):
        stride.append(acc)
        acc *= s
    return tuple(reversed(stride))


def is_device_mesh(mesh) -> bool:
    return getattr(mesh, "mesh_dim_names", None) is not None


def dtensor_placements(spec, mesh) -> tuple:
    """A spec -> one DTensor placement per mesh dim (the port's
    ``NamedSharding``): ``Shard(d)`` on every mesh axis that tensor dim d
    splits over, ``Replicate()`` on the others. The axes of one dim must
    come in mesh order: DTensor splits such a dim over its mesh dims left
    to right, which is the row-major layout JAX gives the same spec. A
    mesh dim of size 1 is ``Replicate()`` whatever the spec says: the two
    are the same layout there, and DTensor cannot reshape a dim that is
    "split" over one rank when the dim itself has size 1 (a micro-batch
    of one row on a one-rank mesh)."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        axes = () if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry))
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"{spec}: dim {d} lists {axes} off the mesh's "
                             f"order {names}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"{spec}: mesh axis {names[i]} used twice")
            out[i] = Shard(d)
    return tuple(Replicate() if mesh.size(i) == 1 else pl
                 for i, pl in enumerate(out))


def fit_spec(shape, spec, mesh):
    """``spec`` with every entry whose dim does not split evenly over its
    axes set to None: the dim stays whole where GSPMD would pad it (an
    uneven DTensor shard cannot be reshaped)."""
    names = tuple(mesh.mesh_dim_names)
    out = []
    for d, entry in enumerate(spec):
        axes = () if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry))
        n = math.prod(mesh.size(names.index(a)) for a in axes)
        out.append(entry if axes and shape[d] % n == 0 else None)
    return P(*out)


def replicated(x, mesh):
    """``x`` as a DTensor over ``mesh``: a DTensor as it is, a plain tensor
    (the same on every rank) with ``Replicate()`` on every mesh dim."""
    from torch.distributed.tensor import DTensor, Replicate
    if isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def with_sharding_constraint(x, mesh, spec):
    """``x`` redistributed to ``spec`` over ``mesh`` (the reference's
    ``jax.lax.with_sharding_constraint``; a dim that does not divide stays
    whole, ``fit_spec``): a DTensor is resharded, with the collectives that
    takes; a plain tensor becomes a DTensor whose every rank holds the
    whole of it (``Replicate`` placements) first."""
    x = replicated(x, mesh)
    return x.redistribute(
        mesh, dtensor_placements(fit_spec(x.shape, spec, mesh), mesh))


def all_reduce_over(t, op: str, mesh, dims):
    """A local tensor reduced (``op`` "sum" or "max") over the ranks of
    ``mesh``'s mesh ``dims``: one functional all-reduce a dim, outside
    autograd (the callers write their own backward)."""
    import torch.distributed._functional_collectives as fc
    for i in dims:
        t = fc.all_reduce(t, op, (mesh, i))
        if isinstance(t, fc.AsyncCollectiveTensor):
            t = t.wait()
    return t


class _GradAnchor(torch.autograd.Function):
    """Identity forward; the backward lays the incoming gradient out as
    the forward's input was laid out, a partial sum reduced (an
    all-reduce): Megatron's f operator. The gradient of a column-parallel
    matmul's input is a partial sum over the model ranks; reduced once
    there, it reaches the norm, the residual stream and the earlier
    layers' row-parallel matmuls whole, where DTensor would otherwise
    gather the other operand of each to keep the sum partial."""

    @staticmethod
    def forward(ctx, x):
        ctx.placements = x.placements
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad.redistribute(grad.device_mesh, ctx.placements)


def grad_anchor(x):
    """DTensor ``x`` itself, its gradient laid out as ``x`` is
    (``_GradAnchor``) when it needs one."""
    if not torch.is_grad_enabled() or not x.requires_grad:
        return x
    return _GradAnchor.apply(x)


def _gather_axes(x, mesh, axes, dim: int):
    """All-gather a local tensor along ``dim`` over mesh ``axes``, tiled in
    row-major order over them (innermost axis first), differentiably."""
    import torch.distributed._functional_collectives as fc
    # the newer name, where this PyTorch has it (same signature)
    gather = getattr(fc, "all_gather_single_autograd",
                     None) or fc.all_gather_tensor_autograd
    for a in reversed(tuple(axes)):
        x = gather(x, gather_dim=dim, group=mesh.get_group(a))
    return x


def _axis_index(mesh, axes) -> int:
    """This rank's flat index over ``axes`` (row-major)."""
    idx = 0
    for a in axes:
        idx = idx * mesh.size(mesh.mesh_dim_names.index(a)) + \
            mesh.get_local_rank(a)
    return idx


def _axes_size(mesh, axes) -> int:
    return math.prod(mesh.size(mesh.mesh_dim_names.index(a)) for a in axes)


def gspmd_flat_search(corpus, q, *, mesh, k: int, metric: str = "cosine",
                      axes=None, valid=None):
    """The flat top-k written with sharding constraints only, DTensor
    choosing the collectives as GSPMD does for the reference: corpus rows
    ``Shard(0)`` over ``axes`` (every mesh axis by default), q
    ``Replicate()``, then the (Q, N) scores, the optional ``valid`` (N,)
    mask and the top-k (``distances.topk_scores``, ties to the lower id).
    ``mesh`` a ``DeviceMesh``; tensors or DTensors in. Returns (scores
    (Q, k), ids (Q, k) int64) replicated, as DTensors."""
    axes = tuple(axes) if axes is not None else tuple(mesh.mesh_dim_names)
    corpus = with_sharding_constraint(corpus, mesh, P(axes, None))
    q = with_sharding_constraint(q, mesh, P(None, None))
    scores = D.pairwise_scores(q, corpus, metric)
    if valid is not None:
        valid = with_sharding_constraint(valid, mesh, P(axes))
        scores = torch.where(valid[None, :], scores, -torch.inf)
    s, i = D.topk_scores(scores, k)
    return (with_sharding_constraint(s, mesh, P(None, None)),
            with_sharding_constraint(i, mesh, P(None, None)))


def _two_level_device_mesh(corpus, q, *, mesh, k, q_axes, c_axes, n_valid,
                           metric):
    """``two_level_search`` over a ``DeviceMesh``: the reference's
    ``shard_map`` body on each rank's shards. Each rank runs ``flat_search``
    (the ``topk_distance`` kernel on a CUDA shard) on its corpus shard
    against its query block, lifts ids by its row offset, and the k
    survivors are all-gathered over ``c_axes`` (tiled, row-major) and
    merged by one more top-k, ties to the lower shard, then slot. Rows and
    queries are padded with zero columns to the kernel's width
    (``distances.pad_width``), which changes no score."""
    from torch.distributed.tensor import DTensor
    corpus = with_sharding_constraint(corpus, mesh, P(c_axes, None))
    q = with_sharding_constraint(q, mesh, P(q_axes, None))
    N = corpus.shape[0]
    n_c = _axes_size(mesh, c_axes)
    if N % n_c:
        raise ValueError(f"{N} corpus rows do not split into {n_c} shards")
    local_n = N // n_c
    # zero columns up to the kernel's width change no score (a flat
    # engine pads its rows the same way at load)
    c_blk, q_blk = D.pad_width(corpus.to_local()), D.pad_width(q.to_local())
    base = _axis_index(mesh, c_axes) * local_n
    valid = (None if n_valid is None else
             base + torch.arange(local_n, device=c_blk.device) < n_valid)
    kk = min(k, local_n)
    s, i = flat_search(c_blk, q_blk, metric=metric, k=kk, valid=valid)
    s, i = D.pad_to_k(*_lift(s, i, base), k)
    s_all = _gather_axes(s, mesh, c_axes, 1)
    i_all = _gather_axes(i, mesh, c_axes, 1)
    top, pos = D.topk_scores(s_all, k)
    ids = torch.gather(i_all, 1, pos)
    pl = dtensor_placements(P(q_axes, None), mesh)
    return (DTensor.from_local(top, mesh, pl, run_check=False),
            DTensor.from_local(ids, mesh, pl, run_check=False))


def merge_candidate_sets(scores, ids, k: int):
    """(S, Q, k') per-shard candidates -> the global (Q, k), ties to the
    lower shard, then the lower slot. Tensors or arrays in, tensors out."""
    scores = torch.as_tensor(scores)
    ids = torch.as_tensor(ids)
    return _merge(list(zip(scores.unbind(0), ids.unbind(0))), k)
