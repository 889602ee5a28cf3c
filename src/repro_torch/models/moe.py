"""Top-k routed MoE with grouped dispatch (GShard/MaxText-style; port of
``repro.models.moe``).

Tokens are reshaped into ``G`` dispatch groups of ``t`` tokens; each group
routes its tokens into per-expert capacity slots (C of them an expert),
the experts run as one batched product over the expert axis, and the
results are combined back with the gates. Two dispatch modes give the
same capacity semantics: ``"einsum"`` (the default), a one-hot (G, t, E,
C) dispatch tensor in x's dtype and a float32 combine tensor cast to x's
dtype before its product, and ``"gather"``, the token id of each (expert,
slot) gathered and each token's k slots gathered back.

Routing is float32 (``x.float() @ router.float()``, without TF32 on the
card, ``device.strict_fp32``): a softmax router (deepseek-v2) or sigmoid
scores with the selected gates normalized (deepseek-v3). The top k take
the first of tied scores, as ``jax.lax.top_k`` does, by a stable sort.
Capacity is assigned in order over the k slots and, within a slot, over
the group's tokens: a token whose expert is full is dropped from that
expert, as in the reference.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import LMConfig, MoEConfig
from repro_torch.device import is_dtensor, strict_fp32
from repro_torch.models.layers import ACTIVATIONS, MLP, apply_mlp, trunc_normal


# Expert-parallel hook (the reference's ``EP_SHARDING``), set by
# ``launch.steps.moe_constraints`` for the duration of a sharded step:
# (mesh, batch axes, expert axes). DTensor dispatch tensors are then
# redistributed to the reference's placements, so that dispatch and combine
# become exchanges between the token shards (the batch axes) and the expert
# owners (the expert axes).
EP_SHARDING = None


def _ep_constrain(x, spec_builder):
    if EP_SHARDING is None or not is_dtensor(x):
        return x
    from repro_torch.core.distributed import with_sharding_constraint
    mesh, dp, e_axes = EP_SHARDING
    spec = spec_builder(dp, e_axes)
    return x if spec is None else with_sharding_constraint(x, mesh, spec)


def _ep_grad_anchor(x):
    if EP_SHARDING is None or not is_dtensor(x):
        return x
    from repro_torch.core.distributed import grad_anchor
    return grad_anchor(x)


def _expert_spec(dp, ea):
    from repro_torch.core.distributed import P
    return (P(dp, "model", None, None) if tuple(ea) == ("model",)
            else P(None, ea, None, None))


def _slot_spec(dp, ea):
    """The (G, t, E) expert choices where the experts split over "model"
    (training), split as x_e and y_e are: each rank builds the dispatch
    and combine slots of its own experts, the dispatch product needs no
    exchange, and its backward and the combine are partial sums over
    "model", all-reduced into the token layout. Elsewhere unconstrained."""
    from repro_torch.core.distributed import P
    return P(dp, None, "model") if tuple(ea) == ("model",) else None


def _token_spec(dp, ea):
    from repro_torch.core.distributed import P
    return P(dp, None, None)


def _group_full(like, shape, value, dtype):
    """A (G, ...) tensor of ``value`` laid out as ``like`` (G, ...) lays out
    its groups: a DTensor's split of G stays, every other dim whole, each
    rank allocating its own groups (a plain tensor would sit whole on
    every rank: v3's (G, t, E, C) combine is 15 GiB)."""
    if not is_dtensor(like):
        return torch.full(shape, value, dtype=dtype, device=like.device)
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.core.distributed import contiguous_stride
    local_g = like.to_local().shape[0]
    local = torch.full((local_g,) + tuple(shape[1:]), value, dtype=dtype,
                       device=like.to_local().device)
    pl = [Shard(0) if p == Shard(0) else Replicate() for p in like.placements]
    return DTensor.from_local(local, like.device_mesh, pl, run_check=False,
                              shape=tuple(shape),
                              stride=contiguous_stride(shape))


class Experts(nn.Module):
    """``w_gate`` and ``w_up`` (E, d, f), ``w_down`` (E, f, d): the
    reference's leaves (drawn there as (d, E, f) and transposed; here drawn
    in their own layout from the same distribution)."""

    def __init__(self, generator, d: int, E: int, f: int, dtype=torch.float32):
        super().__init__()
        self.w_gate = trunc_normal((E, d, f), 1.0 / np.sqrt(d), generator, dtype)
        self.w_up = trunc_normal((E, d, f), 1.0 / np.sqrt(d), generator, dtype)
        self.w_down = trunc_normal((E, f, d), 1.0 / np.sqrt(f), generator, dtype)


class MoE(nn.Module):
    """``router`` (d, E), ``experts`` and, with shared experts, ``shared``
    (one MLP of n_shared * d_ff_expert)."""

    def __init__(self, generator, cfg: LMConfig, dtype=torch.float32):
        super().__init__()
        m, d = cfg.moe, cfg.d_model
        self.router = trunc_normal((d, m.n_routed), 0.02, generator, dtype)
        self.experts = Experts(generator, d, m.n_routed, m.d_ff_expert, dtype)
        self.shared = (MLP(generator, d, m.n_shared * m.d_ff_expert,
                           cfg.gated_mlp, dtype) if m.n_shared else None)


def _top_k(scores, k: int):
    """(values, indices) of the k largest along the last axis, the lower
    index first among equal scores (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _routing(logits_f32, m: MoEConfig, router_score: str):
    """Return (gates, idx): top-k expert ids and normalized gate values."""
    if router_score == "sigmoid":  # deepseek-v3
        scores = torch.sigmoid(logits_f32)
    else:
        scores = torch.softmax(logits_f32, dim=-1)
    gates, idx = _top_k(scores, m.top_k)
    gates = gates / torch.clamp(gates.sum(dim=-1, keepdim=True), min=1e-9)
    return gates, idx


def group_shape(T: int, m: MoEConfig, capacity_factor=None) -> tuple:
    """(G, t, C): groups, tokens a group and slots an expert for T tokens:
    the largest G <= T // group_size that divides T, and
    C = min(max(4, ceil-ish(t k cf / E)), t) as the reference rounds it."""
    G = max(1, T // m.group_size)
    while T % G:
        G -= 1
    t = T // G
    cf = capacity_factor if capacity_factor is not None else m.capacity_factor
    C = max(4, int(t * m.top_k * cf / m.n_routed + 0.999))
    return G, t, min(C, t)


def _assign(idx, E: int, C: int):
    """The capacity assignment, in order over the k slots: for each slot j,
    the (G, t) position of each token in its expert's queue (the tokens of
    the group before it that chose that expert, in this and the earlier
    slots) and whether it is below C. Returns ([slot (G, t)], [kept (G, t)])
    a slot j each."""
    G, t, k = idx.shape
    counts = _group_full(idx, (G, E), 0, torch.int64)
    slots, keeps = [], []
    for j in range(k):
        mj = F.one_hot(idx[:, :, j], E)  # (G, t, E)
        pos = torch.cumsum(mj, dim=1) - mj + counts[:, None, :]
        counts = counts + mj.sum(dim=1)
        keep = (pos < C) & (mj > 0)
        slots.append(torch.where(keep, pos, 0).sum(dim=-1))
        keeps.append(keep.any(dim=-1))
    return slots, keeps


def _expert_mlp(ex: Experts, cfg: LMConfig, x_e):
    """(G, E, C, D) -> (G, E, C, D): each expert's MLP on its slots, one
    batched product over the expert axis, in x's dtype."""
    G, E, C, D = x_e.shape
    dt = x_e.dtype
    xs = x_e.transpose(0, 1).reshape(E, G * C, D)
    h = torch.bmm(xs, ex.w_up.to(dt))
    act = ACTIVATIONS[cfg.act]
    if cfg.gated_mlp:
        h = act(torch.bmm(xs, ex.w_gate.to(dt))) * h
    else:
        h = act(h)
    y = torch.bmm(h, ex.w_down.to(dt))  # (E, G*C, D)
    return y.reshape(E, G, C, D).transpose(0, 1)


def apply_moe(p: MoE, cfg: LMConfig, x, *, capacity_factor=None,
              router_score: str = "softmax"):
    """x: (B, S, D) -> (y (B, S, D) in x's dtype, aux): aux holds the
    float32 scalars ``load_balance``, ``router_z`` and ``dropped_frac``
    (the share of the T k assignments that found their expert full)."""
    m = cfg.moe
    B, S, D = x.shape
    T = B * S
    G, t, C = group_shape(T, m, capacity_factor)
    E, k = m.n_routed, m.top_k
    dt = x.dtype
    xg = _ep_constrain(x.reshape(G, t, D), _token_spec)
    with strict_fp32():
        logits = xg.float() @ p.router.float()  # (G, t, E)
    gates, idx = _routing(logits, m, router_score)
    slots, keeps = _assign(idx, E, C)
    kept = torch.stack(keeps, dim=-1)  # (G, t, k)

    if m.dispatch == "gather":
        # token id per (expert, slot): a scatter into E*C slots and a dump
        # slot for the dropped assignments, then one row gather
        slot_id = torch.stack([torch.where(kp, idx[:, :, j] * C + sl, E * C)
                               for j, (sl, kp) in enumerate(zip(slots, keeps))],
                              dim=-1).reshape(G, t * k)
        tok_of = torch.arange(t, device=x.device).repeat_interleave(k)
        token_at_slot = _group_full(xg, (G, E * C + 1), t, torch.int64)
        token_at_slot.scatter_(1, slot_id, tok_of.expand(G, -1).contiguous())
        xg_pad = torch.cat([xg, xg.new_zeros((G, 1, D))], dim=1)
        x_e = torch.gather(xg_pad, 1, token_at_slot[:, :E * C, None]
                           .expand(-1, -1, D)).reshape(G, E, C, D)
        x_e = _ep_constrain(x_e, _expert_spec)
        y_e = _ep_constrain(_expert_mlp(p.experts, cfg, x_e), _expert_spec)
        safe = torch.clamp(slot_id, max=E * C - 1)
        picked = torch.gather(y_e.reshape(G, E * C, D), 1,
                              safe[..., None].expand(-1, -1, D))
        w = torch.where(kept, gates, 0.0).to(dt)  # (G, t, k)
        y = (picked.reshape(G, t, k, D).float() * w.float()[..., None]
             ).sum(dim=2).to(dt)
        n_kept = kept.float().sum()
    else:
        # sums over the k slots from the first one's terms (0 + x is x);
        # the gates' gradient, a partial sum over the experts' ranks, is
        # reduced at the gates (G, t, k), not later at the tokens (G, t, D)
        gates = _ep_grad_anchor(gates)
        dispatch = combine = None
        for j in range(k):
            slot_oh = F.one_hot(slots[j], C)  # (G, t, C)
            sel = _ep_constrain(F.one_hot(idx[:, :, j], E)
                                * keeps[j][..., None], _slot_spec)  # (G, t, E)
            onehot = sel[..., None] * slot_oh[:, :, None, :]
            d_j = onehot.to(dt)
            c_j = gates[:, :, j, None, None] * onehot.float()
            dispatch = d_j if dispatch is None else dispatch + d_j
            combine = c_j if combine is None else combine + c_j
        # each (expert, slot) holds one token at most: the sum is a copy;
        # its backward's partial sum over the experts is reduced into xg's
        # layout before it meets the router's gradient
        x_e = _ep_constrain(torch.einsum("gtec,gtd->gecd", dispatch,
                                         _ep_grad_anchor(xg)), _expert_spec)
        y_e = _ep_constrain(_expert_mlp(p.experts, cfg, x_e), _expert_spec)
        y = torch.bmm(combine.to(dt).reshape(G, t, E * C),
                      y_e.reshape(G, E * C, D))
        n_kept = dispatch.float().sum()
    y = _ep_constrain(y, _token_spec).reshape(B, S, D)

    if p.shared is not None:
        y = y + apply_mlp(p.shared, x, cfg.act)

    # aux losses, float32
    probs = torch.softmax(logits, dim=-1)
    density = F.one_hot(idx[:, :, 0], E).float().mean(dim=(0, 1))
    p_mean = probs.mean(dim=(0, 1))
    aux = {
        "load_balance": E * (density * p_mean).sum() * m.router_aux_weight,
        "router_z": (torch.logsumexp(logits, dim=-1) ** 2).mean()
        * m.router_z_weight,
        "dropped_frac": 1.0 - n_kept / (T * k),
    }
    return y, aux
