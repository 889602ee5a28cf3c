"""GraphSAGE [arXiv:1706.02216] with scatter-sum message passing (port of
``repro.models.gnn``).

Message passing runs directly over an edge index: a gather of the source
rows, then ``index_add`` (sum, mean) or ``scatter_reduce(..., "amax")``
(max) into the destination nodes, the reference's ``segment_sum`` and
``segment_max``. Three execution modes:

  * full-graph   : forward(feats, edges, edge_mask)        -- cora / ogbn-products
  * sampled      : forward_blocks(block list from sampler) -- reddit minibatch
  * batched small: forward_graphs(packed graphs + readout) -- molecule batches

plus a host-side NeighborSampler (numpy CSR, uniform fanout), whose draws
from a seed are the reference's. On the card the scatter sums are atomics
unless ``torch.use_deterministic_algorithms(True)`` is on (the trainer CLI
sets it).

    init(cfg, generator, device=None, trainable=False) -> GraphSAGE
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import GNNConfig
from repro_torch.device import is_dtensor, resolve_device
from repro_torch.models.layers import dense_init


# ================================================================ params


class SageLayer(nn.Module):
    """``w_self`` and ``w_neigh`` (d_prev, d_hidden), ``b`` (d_hidden,)."""

    def __init__(self, generator, d_in: int, d_out: int, dtype):
        super().__init__()
        self.w_self = dense_init(generator, d_in, d_out, dtype)
        self.w_neigh = dense_init(generator, d_in, d_out, dtype)
        self.b = nn.Parameter(torch.zeros(d_out, dtype=dtype,
                                          device=generator.device))


class GraphSAGE(nn.Module):
    """``layers`` (a list of ``SageLayer``) and ``head`` (``w`` (d_hidden,
    n_classes), ``b``): the reference's tree."""

    def __init__(self, cfg: GNNConfig, generator):
        super().__init__()
        dtype = getattr(torch, cfg.param_dtype)
        dims = [cfg.d_in] + [cfg.d_hidden] * cfg.n_layers
        self.layers = nn.ModuleList(SageLayer(generator, dims[i], dims[i + 1],
                                              dtype)
                                    for i in range(cfg.n_layers))
        self.head = SageHead(generator, dims[-1], cfg.n_classes, dtype)


class SageHead(nn.Module):
    def __init__(self, generator, d: int, n_classes: int, dtype):
        super().__init__()
        self.w = dense_init(generator, d, n_classes, dtype)
        self.b = nn.Parameter(torch.zeros(n_classes, dtype=dtype,
                                          device=generator.device))


def init(cfg: GNNConfig, generator: torch.Generator, device=None, *,
         trainable: bool = False) -> GraphSAGE:
    """Parameters drawn from ``generator`` on its device, then moved to
    ``device`` (the card unless given ``device="cpu"``; without a card,
    None raises before anything is drawn). Frozen unless ``trainable``."""
    dev = resolve_device(device)
    return GraphSAGE(cfg, generator).to(dev).requires_grad_(trainable)


# ================================================================ aggregation


def _gather_rows(h, idx):
    """``h[idx]``; on DTensors (a sharded step) each rank gathers from the
    whole of h (an all-gather where it is split, as GSPMD gathers by ids
    that cross shards) the rows of its own ids, and the rows come back
    split like the ids."""
    if not (is_dtensor(h) or is_dtensor(idx)):
        return h[idx]
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from repro_torch.core.distributed import replicated
    mesh = (h if is_dtensor(h) else idx).device_mesh
    whole = [Replicate()] * mesh.ndim
    h, idx = replicated(h, mesh), replicated(idx, mesh)
    rows = [Shard(0) if p == Shard(0) else Replicate()
            for p in idx.placements]
    # a rank's gradient of h covers its own ids: a partial sum over the
    # mesh dims that split them
    grad_pl = [Partial() if p == Shard(0) else Replicate() for p in rows]
    got = h.redistribute(mesh, whole).to_local(grad_placements=grad_pl)[
        idx.redistribute(mesh, rows).to_local()]
    return DTensor.from_local(got, mesh, rows, run_check=False,
                              shape=tuple(idx.shape) + tuple(h.shape[1:]),
                              stride=got.stride())


def _segment_sum(values, ids, n: int):
    if is_dtensor(values) or is_dtensor(ids):
        return _segment_sum_sharded(values, ids, n)
    return values.new_zeros((n,) + values.shape[1:]).index_add(0, ids, values)


def _segment_sum_sharded(values, ids, n: int):
    """``_segment_sum`` on DTensors (a sharded step), as GSPMD lowers the
    reference's ``segment_sum`` over sharded edges: values and ids split
    their rows alike (a mesh dim that splits either splits both; any other
    placement is made whole), each rank sums its own rows into all n
    segments, and the result is that partial sum (``Partial()`` over the
    mesh dims that split the rows), which DTensor reduces where it is read.
    Differentiable, as ``index_add`` is in ``values``."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from repro_torch.core.distributed import replicated
    mesh = (values if is_dtensor(values) else ids).device_mesh
    values, ids = replicated(values, mesh), replicated(ids, mesh)
    rows = [Shard(0) if Shard(0) in (a, b) else Replicate()
            for a, b in zip(values.placements, ids.placements)]
    v = values.redistribute(mesh, rows).to_local()
    i = ids.redistribute(mesh, rows).to_local()
    local = v.new_zeros((n,) + v.shape[1:]).index_add(0, i, v)
    out = [Partial() if r == Shard(0) else Replicate() for r in rows]
    return DTensor.from_local(local, mesh, out, run_check=False,
                              shape=(n,) + tuple(values.shape[1:]),
                              stride=local.stride())


def _aggregate(messages, dst, n_nodes: int, mode: str, edge_mask=None):
    """messages: (E, d) gathered from src; scatter-reduce into dst nodes.
    max: a node with no edge gets -inf, mapped to 0 (the reference's
    ``segment_max`` then ``isfinite``); a node whose edges are all masked
    gets -1e30, as there."""
    dst = dst.long()
    if edge_mask is not None:
        messages = torch.where(edge_mask[:, None], messages, 0.0)
    if mode == "max":
        m = messages if edge_mask is None else torch.where(
            edge_mask[:, None], messages, -1e30)
        init_ = m.new_full((n_nodes, m.shape[1]), -torch.inf)
        agg = init_.scatter_reduce(0, dst[:, None].expand_as(m), m,
                                   reduce="amax", include_self=True)
        return torch.where(torch.isfinite(agg), agg, 0.0)
    s = _segment_sum(messages, dst, n_nodes)
    if mode == "sum":
        return s
    ones = torch.ones(messages.shape[0], dtype=messages.dtype,
                      device=messages.device)
    if edge_mask is not None:
        ones = ones * edge_mask.to(messages.dtype)
    deg = _segment_sum(ones, dst, n_nodes)
    return s / torch.clamp(deg, min=1.0)[:, None]


def _sage_layer(p, h_src, h_dst, src, dst, n_dst: int, mode: str,
                edge_mask=None, msg_dtype=None):
    # messages cross in msg_dtype (the reference casts before its gather,
    # which crosses shards there); the reduction is float32
    h_gather = h_src if msg_dtype is None else h_src.to(getattr(torch, msg_dtype))
    msgs = _gather_rows(h_gather, src.long()).float()
    agg = _aggregate(msgs, dst, n_dst, mode, edge_mask).to(h_dst.dtype)
    out = F.relu(h_dst @ p.w_self + agg @ p.w_neigh + p.b)
    # L2 normalize, per the GraphSAGE paper (alg. 1, line 7)
    norm = torch.linalg.vector_norm(out, dim=-1, keepdim=True)
    return out / torch.clamp(norm, min=1e-6)


def _nll(logits, labels):
    logp = F.log_softmax(logits, dim=-1)
    if is_dtensor(logp):
        # the label's log-probability among exact zeros: no gather, whose
        # backward a DTensor may have no rule for
        hit = (torch.arange(logp.shape[-1], device=logp.device)
               == labels.long()[:, None])
        return -torch.where(hit, logp, 0.0).sum(dim=-1)
    return -torch.gather(logp, -1, labels.long()[:, None])[:, 0]


# ================================================================ full graph


def forward(params, cfg: GNNConfig, feats, edges, edge_mask=None):
    """feats: (N, d_in); edges: (2, E) int [src; dst] -> node logits (N, C)."""
    h = feats.to(getattr(torch, cfg.dtype))
    src, dst = edges[0], edges[1]
    n = feats.shape[0]
    for p in params.layers:
        h = _sage_layer(p, h, h, src, dst, n, cfg.aggregator, edge_mask,
                        msg_dtype=cfg.message_dtype)
    return h @ params.head.w + params.head.b


def node_loss(params, cfg: GNNConfig, batch):
    """batch: feats, edges, edge_mask?, labels (N,), label_mask (N,) bool."""
    logits = forward(params, cfg, batch["feats"], batch["edges"],
                     batch.get("edge_mask")).float()
    labels, lm = batch["labels"], batch["label_mask"]
    nll = _nll(logits, torch.where(lm, labels, 0))
    denom = torch.clamp(lm.sum(), min=1)
    loss = torch.where(lm, nll, 0.0).sum() / denom
    acc = (lm & (logits.argmax(-1) == labels)).sum() / denom
    return loss, {"loss": loss, "acc": acc}


# ================================================================ sampled blocks


def forward_blocks(params, cfg: GNNConfig, feats, blocks):
    """Layer-wise sampled forward (deepest frontier first).

    feats: (N_L, d_in) features of the deepest frontier. blocks: list length
    n_layers, shallowest-last: {"src": (E_l,), "dst": (E_l,), "edge_mask": (E_l,),
    "n_dst": int, "self_idx": (n_dst,)} -- src indexes the previous frontier,
    self_idx maps dst nodes to their own row in the previous frontier.
    """
    h = feats.to(getattr(torch, cfg.dtype))
    for p, blk in zip(params.layers, blocks):
        h_dst = _gather_rows(h, blk["self_idx"].long())
        h = _sage_layer(p, h, h_dst, blk["src"], blk["dst"], int(blk["n_dst"]),
                        cfg.aggregator, blk.get("edge_mask"),
                        msg_dtype=cfg.message_dtype)
    return h @ params.head.w + params.head.b


def block_loss(params, cfg: GNNConfig, batch):
    logits = forward_blocks(params, cfg, batch["feats"], batch["blocks"]).float()
    labels = batch["labels"]
    loss = _nll(logits, labels).mean()
    return loss, {"loss": loss,
                  "acc": (logits.argmax(-1) == labels).float().mean()}


# ================================================================ batched graphs


def forward_graphs(params, cfg: GNNConfig, feats, edges, graph_ids, n_graphs,
                   edge_mask=None, node_mask=None):
    """Packed small graphs; mean readout per graph -> (n_graphs, C) logits."""
    h = feats.to(getattr(torch, cfg.dtype))
    src, dst = edges[0], edges[1]
    n = feats.shape[0]
    for p in params.layers:
        h = _sage_layer(p, h, h, src, dst, n, cfg.aggregator, edge_mask,
                        msg_dtype=cfg.message_dtype)
    graph_ids = graph_ids.long()
    n_graphs = int(n_graphs)
    if node_mask is not None:
        h = torch.where(node_mask[:, None], h, 0.0)
        cnt = _segment_sum(node_mask.to(h.dtype), graph_ids, n_graphs)
    else:
        cnt = _segment_sum(h.new_ones(n), graph_ids, n_graphs)
    pooled = _segment_sum(h, graph_ids, n_graphs)
    pooled = pooled / torch.clamp(cnt, min=1.0)[:, None]
    return pooled @ params.head.w + params.head.b


def graph_loss(params, cfg: GNNConfig, batch):
    logits = forward_graphs(params, cfg, batch["feats"], batch["edges"],
                            batch["graph_ids"], batch["n_graphs"],
                            batch.get("edge_mask"),
                            batch.get("node_mask")).float()
    labels = batch["labels"]
    loss = _nll(logits, labels).mean()
    return loss, {"loss": loss,
                  "acc": (logits.argmax(-1) == labels).float().mean()}


# ================================================================ sampler


def stable_order(keys: np.ndarray) -> np.ndarray:
    """``np.argsort(keys, kind="stable")`` for non-negative keys below
    2^32, as two stable radix passes over 16-bit halves (numpy sorts
    16-bit keys by radix): low half first, then the high half."""
    keys = np.asarray(keys).astype(np.uint32, copy=False)
    order = np.argsort((keys & 0xFFFF).astype(np.uint16), kind="stable")
    high = (keys[order] >> 16).astype(np.uint16)
    return order[np.argsort(high, kind="stable")]


class NeighborSampler:
    """Host-side uniform neighbor sampler (GraphSAGE minibatch training).

    Builds CSR once from the edge index; ``sample(seeds)`` returns blocks,
    deepest frontier first, ready for forward_blocks (``pad_sample`` pads
    them to static shapes). numpy, drawn as the reference draws: one seed
    gives the same blocks in both packages. The CSR is the reference's
    (edges in a stable order by destination, degrees counted), built by
    two 16-bit radix passes and ``np.bincount`` instead of a comparison
    sort and ``np.add.at``: the same arrays, about 10x faster at reddit's
    114 M edges.
    """

    def __init__(self, edges: np.ndarray, n_nodes: int, fanouts: Sequence[int],
                 seed: int = 0):
        src, dst = np.asarray(edges[0]), np.asarray(edges[1])
        self.nbr = src[stable_order(dst)]
        self.indptr = np.zeros(n_nodes + 1, np.int64)
        self.indptr[1:] = np.bincount(dst, minlength=n_nodes)
        self.indptr = np.cumsum(self.indptr)
        self.n_nodes = n_nodes
        self.fanouts = list(fanouts)
        self.rng = np.random.default_rng(seed)

    def _sample_neighbors(self, nodes: np.ndarray, fanout: int):
        """Returns (src_nodes (len(nodes), fanout), valid mask)."""
        starts = self.indptr[nodes]
        degs = self.indptr[nodes + 1] - starts
        r = self.rng.integers(0, np.maximum(degs, 1)[:, None], size=(len(nodes), fanout))
        idx = starts[:, None] + r
        srcs = self.nbr[np.minimum(idx, len(self.nbr) - 1)]
        valid = (degs > 0)[:, None] & np.ones((1, fanout), bool)
        return srcs, valid

    def sample(self, seeds: np.ndarray):
        """seeds: (B,) target nodes. Returns (input_node_ids, blocks)."""
        blocks = []
        frontier = np.asarray(seeds)
        # walk outward (shallow -> deep), recording one bipartite block per hop
        for fanout in reversed(self.fanouts):
            srcs, valid = self._sample_neighbors(frontier, fanout)
            flat_src_nodes = srcs.reshape(-1)
            # next frontier = dst nodes first (self loops), then sampled neighbors
            next_frontier, inv = np.unique(
                np.concatenate([frontier, flat_src_nodes]), return_inverse=True)
            self_idx = inv[: len(frontier)]
            src_local = inv[len(frontier):]
            dst_local = np.repeat(np.arange(len(frontier)), fanout)
            blocks.append({
                "src": src_local.astype(np.int32),
                "dst": dst_local.astype(np.int32),
                "edge_mask": valid.reshape(-1),
                "n_dst": len(frontier),
                "self_idx": self_idx.astype(np.int32),
            })
            frontier = next_frontier
        return frontier, list(reversed(blocks))


def block_static_shapes(batch_nodes: int, fanouts: Sequence[int]):
    """Padded static (n_dst, n_edges, n_src) caps per block, deepest first,
    for the host padder. Mirrors the sampler's loop exactly (shallow->deep
    walk, deepest-first return)."""
    sizes = [batch_nodes]  # frontier caps, shallow -> deep
    loop_blocks = []
    for fanout in reversed(list(fanouts)):
        n_dst = sizes[-1]
        loop_blocks.append({"n_dst": n_dst, "n_edges": n_dst * fanout,
                            "n_src": n_dst * (1 + fanout)})
        sizes.append(n_dst * (1 + fanout))
    return sizes[-1], list(reversed(loop_blocks))


def pad_sample(input_nodes, blocks, batch_nodes: int, fanouts: Sequence[int]):
    """Pad a NeighborSampler.sample() result to static shapes (the
    reference's, for jit; here they keep a step's shapes fixed)."""
    max_in, shapes = block_static_shapes(batch_nodes, fanouts)
    padded_nodes = np.zeros(max_in, np.int64)
    padded_nodes[: len(input_nodes)] = input_nodes
    out = []
    for blk, sh in zip(blocks, shapes):
        e = sh["n_edges"]
        pb = {
            "src": np.zeros(e, np.int32), "dst": np.zeros(e, np.int32),
            "edge_mask": np.zeros(e, bool), "n_dst": sh["n_dst"],
            "self_idx": np.zeros(sh["n_dst"], np.int32),
        }
        ne = len(blk["src"])
        pb["src"][:ne] = blk["src"]
        pb["dst"][:ne] = blk["dst"]
        pb["edge_mask"][:ne] = blk["edge_mask"]
        pb["self_idx"][: blk["n_dst"]] = blk["self_idx"]
        out.append(pb)
    return padded_nodes, out
