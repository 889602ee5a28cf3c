"""Shared layers: norms, rotary embedding, MLPs, initializers (port of
``repro.models.layers``).

Each layer is an ``nn.Module`` holding its parameters under the
reference's leaf names, and an ``apply_*`` function over it that computes
the layer as the reference does: in the activation dtype, with norm and
rotary math in float32 and the float32 parameters cast to the activation
dtype at each product (``x @ w.astype(x.dtype)``).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.device import is_dtensor


def trunc_normal(shape, std: float, generator: torch.Generator,
                 dtype=torch.float32) -> nn.Parameter:
    """Normal(0, std) truncated at +-2 std, drawn from ``generator`` on its
    device (``trunc_normal_`` takes absolute bounds). On the ``meta``
    device (``MetaGenerator``) nothing is drawn or allocated: the leaf has
    its shape and dtype only."""
    t = torch.empty(shape, dtype=torch.float32, device=generator.device)
    if t.device.type != "meta":
        nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=generator)
    return nn.Parameter(t.to(dtype))


class MetaGenerator:
    """Stands in for a ``torch.Generator`` when a model is built for its
    shapes only: every leaf lands on the ``meta`` device, undrawn
    (``launch.steps.abstract_state``)."""

    device = torch.device("meta")


def dense_init(generator, d_in: int, d_out, dtype=torch.float32, *,
               std: float | None = None) -> nn.Parameter:
    """Fan-in scaled init for a (d_in, *d_out) projection."""
    shape = (d_in,) + (tuple(d_out) if isinstance(d_out, (tuple, list)) else (d_out,))
    std = std if std is not None else 1.0 / np.sqrt(d_in)
    return trunc_normal(shape, std, generator, dtype)


# ---------------------------------------------------------------- norms


class Norm(nn.Module):
    """LayerNorm (``scale`` and ``bias``) or RMSNorm (``scale`` only)."""

    def __init__(self, kind: str, d: int, dtype=torch.float32, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d, dtype=dtype, device=device))
        if kind == "rmsnorm":
            self.register_parameter("bias", None)
        else:
            self.bias = nn.Parameter(torch.zeros(d, dtype=dtype, device=device))


def apply_norm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm or LayerNorm depending on the params present; f32 accumulate."""
    xf = x.float()
    if p.bias is not None:  # layernorm
        mu = xf.mean(dim=-1, keepdim=True)
        var = torch.square(xf - mu).mean(dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * p.scale.float() + p.bias.float()
    else:  # rmsnorm
        ms = torch.square(xf).mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * p.scale.float()
    return y.to(x.dtype)


# ---------------------------------------------------------------- rotary


def rope_freqs(d_rot: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, d_rot, 2, dtype=np.float32) / d_rot))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               rope_pct: float = 1.0) -> torch.Tensor:
    """x: (..., S, H, dh); positions: broadcastable to (..., S). Partial
    rotary rotates only the first ``rope_pct * dh`` dims (rotate-half, as
    GPT-NeoX and llama)."""
    dh = x.shape[-1]
    d_rot = int(dh * rope_pct)
    d_rot -= d_rot % 2
    if d_rot == 0:
        return x
    freqs = torch.as_tensor(rope_freqs(d_rot, theta), device=x.device)
    angles = positions[..., None].float() * freqs  # (..., S, d_rot/2)
    cos = torch.cos(angles)[..., None, :]  # (..., S, 1, d_rot/2)
    sin = torch.sin(angles)[..., None, :]
    x_rot, x_pass = x[..., :d_rot], x[..., d_rot:]
    x1 = x_rot[..., : d_rot // 2].float()
    x2 = x_rot[..., d_rot // 2:].float()
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    return torch.cat([r1.to(x.dtype), r2.to(x.dtype), x_pass], dim=-1)


# ---------------------------------------------------------------- MLP


class MLP(nn.Module):
    """``w_up`` (d, ff), ``w_gate`` (d, ff) when gated, ``w_down`` (ff, d)."""

    def __init__(self, generator, d: int, ff: int, gated: bool,
                 dtype=torch.float32):
        super().__init__()
        self.w_up = dense_init(generator, d, ff, dtype)
        if gated:
            self.w_gate = dense_init(generator, d, ff, dtype)
        else:
            self.register_parameter("w_gate", None)
        self.w_down = dense_init(generator, ff, d, dtype)


def _gelu_tanh(x):
    # jax.nn.gelu defaults to the tanh approximation; torch's to the erf
    return F.gelu(x, approximate="tanh")


ACTIVATIONS = {"silu": F.silu, "gelu": _gelu_tanh, "relu": F.relu}


def apply_mlp(p, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    act_fn = ACTIVATIONS[act]
    up = x @ p.w_up.to(x.dtype)
    if p.w_gate is not None:
        up = act_fn(x @ p.w_gate.to(x.dtype)) * up
    else:
        up = act_fn(up)
    return up @ p.w_down.to(x.dtype)


# ---------------------------------------------------------------- embedding


class Embed(nn.Module):
    """``table`` (vocab, d), std 0.02."""

    def __init__(self, generator, vocab: int, d: int, dtype=torch.float32):
        super().__init__()
        self.table = trunc_normal((vocab, d), 0.02, generator, dtype)


def apply_embed(p, tokens: torch.Tensor, dtype) -> torch.Tensor:
    if is_dtensor(p.table):
        return embedding(tokens.long(), p.table).to(dtype)
    return p.table[tokens.long()].to(dtype)


def log_sigmoid(x):
    """``F.logsigmoid(x)``; on a DTensor (which has no sharding rule for
    it) elementwise on each rank's shard, the split kept (a partial sum
    is summed first). Differentiable."""
    if not is_dtensor(x):
        return F.logsigmoid(x)
    from torch.distributed.tensor import DTensor, Partial, Replicate

    from repro_torch.core.distributed import contiguous_stride
    pl = [Replicate() if isinstance(p, Partial) else p for p in x.placements]
    x = x.redistribute(x.device_mesh, pl)
    return DTensor.from_local(F.logsigmoid(x.to_local()), x.device_mesh, pl,
                              run_check=False, shape=x.shape,
                              stride=contiguous_stride(x.shape))


def embedding(idx, table):
    """``F.embedding(idx, table)``; a DTensor table (a sharded step's:
    recsys tables split by rows over the mesh, the DLRM layout, or an LM
    vocabulary over "model") looks up on each rank's shard
    (``_sharded_lookup``)."""
    if is_dtensor(table):
        return _sharded_lookup(idx, table)
    return F.embedding(idx, table)


def _sharded_lookup(idx, table):
    """The row-split lookup, as GSPMD lowers a gather from a row-sharded
    table: the ids are made whole over the mesh dims that split the rows,
    each rank reads the rows it holds (a zero row for the others), the sum
    over those ranks (a ``Partial``) is the lookup, and it comes back in
    the ids' batch layout. Differentiable in the table."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from repro_torch.core.distributed import _axis_index, replicated
    mesh = table.device_mesh
    names = mesh.mesh_dim_names
    idx = replicated(idx, mesh)
    rows = [i for i, p in enumerate(table.placements) if p == Shard(0)]
    if any(not isinstance(p, Replicate) and i not in rows
           for i, p in enumerate(table.placements)):
        table = table.redistribute(mesh, [Shard(0) if i in rows
                                          else Replicate()
                                          for i in range(mesh.ndim)])
    batch_pl = [Shard(0) if p == Shard(0) else Replicate()
                for p in idx.placements]
    idx_pl = [Replicate() if i in rows else p for i, p in enumerate(batch_pl)]
    ids = idx.redistribute(mesh, idx_pl).to_local().long()
    # a rank's table gradient covers its own ids: a partial sum over the
    # mesh dims that split the ids, its own rows over those that split
    # the table
    local = table.to_local(grad_placements=[
        Shard(0) if i in rows else
        (Partial() if p == Shard(0) else Replicate())
        for i, p in enumerate(idx_pl)])
    n_loc = local.shape[0]
    ids = ids - _axis_index(mesh, [names[i] for i in rows]) * n_loc
    hit = (ids >= 0) & (ids < n_loc)
    got = F.embedding(ids.clamp(0, n_loc - 1), local) * hit[..., None]
    out_pl = [Partial() if i in rows else p for i, p in enumerate(idx_pl)]
    shape = tuple(idx.shape) + (table.shape[1],)
    out = DTensor.from_local(got, mesh, out_pl, run_check=False,
                             shape=shape, stride=got.stride())
    split = math.prod(mesh.size(i) for i, p in enumerate(batch_pl)
                      if p == Shard(0))
    return out.redistribute(mesh, batch_pl if shape[0] % split == 0
                            else [Replicate()] * mesh.ndim)

