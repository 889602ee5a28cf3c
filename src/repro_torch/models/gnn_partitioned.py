"""Partition-aware full-graph GraphSAGE (port of
``repro.models.gnn_partitioned``).

The sharded baseline reduces ``segment_sum(msgs, dst)`` over edges split
across the data ranks into a full (N, d_hidden) float32 all-reduce per
layer and direction. Owner-computes fixes the layout instead of the math:

  * edges are pre-sorted by dst shard on the host (``partition_edges``), so
    every rank reduces ONLY its own nodes' incoming messages: the
    scatter's all-reduce disappears;
  * the src-side neighbor features arrive through ONE all-gather of the
    node states per layer (in ``message_dtype``), the minimal exchange, since
    a random graph's cut touches every shard;
  * each rank runs the layer on its own shards with explicit collectives
    (the reference's ``shard_map`` body), so the schedule is explicit.

Here the body runs on each rank's local tensors (``DTensor.to_local``), the
all-gather is the differentiable functional collective, and the per-rank
[loss_sum, n, acc_sum] row comes back as a DTensor split over the data
ranks, summed OUTSIDE the body, as the reference sums it (a sum inside
would sit on the loss's gradient path as a collective of its own).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import GNNConfig
from repro_torch.core.distributed import (P, _axes_size, _axis_index,
                                          _gather_axes, dtensor_placements,
                                          with_sharding_constraint)


def partition_edges(edges: np.ndarray, n_nodes: int, n_shards: int):
    """Host-side layout: sort edges by dst shard, pad shards to equal count.

    Returns (edges_out (2, n_shards*cap) int32 — src stays global, dst stays
    global; valid (n_shards*cap,) bool; cap).
    """
    assert n_nodes % n_shards == 0, (n_nodes, n_shards)
    n_local = n_nodes // n_shards
    src, dst = np.asarray(edges[0]), np.asarray(edges[1])
    shard = dst // n_local
    order = np.argsort(shard, kind="stable")
    src, dst, shard = src[order], dst[order], shard[order]
    counts = np.bincount(shard, minlength=n_shards)
    cap = int(counts.max())
    out = np.zeros((2, n_shards * cap), np.int32)
    valid = np.zeros((n_shards * cap,), bool)
    starts = np.concatenate([[0], np.cumsum(counts)])
    for s in range(n_shards):
        lo, hi = starts[s], starts[s + 1]
        out[0, s * cap: s * cap + (hi - lo)] = src[lo:hi]
        out[1, s * cap: s * cap + (hi - lo)] = dst[lo:hi]
        valid[s * cap: s * cap + (hi - lo)] = True
    return out, valid, cap


def make_partitioned_loss(cfg: GNNConfig, mesh, dp_axes, n_nodes: int):
    """Returns loss_fn(params, batch) running the owner-computes program on
    ``mesh`` (a ``DeviceMesh``); ``params`` a ``models.gnn`` module,
    replicated: DTensor parameters get the gradient summed over the dp
    ranks; plain tensors get each rank's own nodes' share, which the
    caller sums.

    batch (tensors or DTensors, placed here): feats (N, d) P(dp); edges
    (2, S*cap) P(None, dp) laid out by ``partition_edges``; edge_valid
    (S*cap,) P(dp); labels / label_mask (N,) P(dp).
    """
    from torch.distributed.tensor import DTensor, Partial
    dp = tuple(dp_axes)
    n_shards = _axes_size(mesh, dp)
    n_local = n_nodes // n_shards
    msg_dtype = getattr(torch, cfg.message_dtype)
    dtype = getattr(torch, cfg.dtype)

    def local(x):
        # a replicated parameter's gradient on a rank covers the rank's own
        # nodes: a partial sum over the dp axes, which DTensor reduces
        if not isinstance(x, DTensor):
            return x
        names = mesh.mesh_dim_names
        return x.to_local(grad_placements=[
            Partial() if names[i] in dp else pl
            for i, pl in enumerate(x.placements)])

    def local_loss(params, feats, edges, edge_valid, labels, label_mask):
        idx = _axis_index(mesh, dp)
        src, dst = edges[0].long(), edges[1].long()
        dst_local = dst - idx * n_local
        h = feats.to(dtype)  # (n_local, d)
        for p in params.layers:
            # THE exchange: every rank's node states, (N, d)
            h_all = _gather_axes(h.to(msg_dtype), mesh, dp, 0)
            msgs = h_all[src].float()
            msgs = torch.where(edge_valid[:, None], msgs, 0.0)
            s = msgs.new_zeros((n_local, msgs.shape[1])).index_add(
                0, dst_local, msgs)
            if cfg.aggregator == "mean":
                deg = msgs.new_zeros(n_local).index_add(
                    0, dst_local, edge_valid.float())
                s = s / torch.clamp(deg, min=1.0)[:, None]
            agg = s.to(h.dtype)
            out = F.relu(h @ local(p.w_self) + agg @ local(p.w_neigh)
                         + local(p.b))
            h = out / torch.clamp(torch.linalg.norm(out, dim=-1,
                                                    keepdim=True), min=1e-6)
        logits = (h @ local(params.head.w) + local(params.head.b)).float()
        safe = torch.where(label_mask, labels, 0).long()
        nll = (torch.logsumexp(logits, dim=-1)
               - torch.gather(logits, -1, safe[:, None])[:, 0])
        loss_sum = torch.where(label_mask, nll, 0.0).sum()
        n = label_mask.float().sum()
        acc_sum = (label_mask & (logits.argmax(-1) == labels)).float().sum()
        return torch.stack([loss_sum, n, acc_sum])[None, :]

    def loss_fn(params, batch):
        parts = [with_sharding_constraint(batch[name], mesh, spec).to_local()
                 for name, spec in (("feats", P(dp, None)),
                                    ("edges", P(None, dp)),
                                    ("edge_valid", P(dp)),
                                    ("labels", P(dp)),
                                    ("label_mask", P(dp)))]
        row = local_loss(params, *parts)
        rows = DTensor.from_local(row, mesh,
                                  dtensor_placements(P(dp, None), mesh),
                                  run_check=False)
        loss_sum, n, acc_sum = rows.sum(dim=0).full_tensor()
        n = torch.clamp(n, min=1.0)
        loss = loss_sum / n
        return loss, {"loss": loss, "acc": acc_sum / n}

    return loss_fn
