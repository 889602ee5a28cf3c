"""Synthetic graphs for the GNN arch: SBM node classification + minigraphs
(port of ``repro.data.graphs``: host numpy, the same arrays from a seed)."""
from __future__ import annotations

import numpy as np


def sbm_graph(n_nodes: int, n_classes: int, d_feat: int, *, avg_degree: int = 8,
              p_in_out_ratio: float = 8.0, seed: int = 0):
    """Stochastic block model with class-correlated features.

    Returns dict(feats (N, d) f32, edges (2, E) i32 — both directions,
    labels (N,), label_mask (N,) bool train split).
    """
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, n_classes, size=n_nodes)
    # sample edges by proposing pairs and keeping same-class ones more often
    target_e = n_nodes * avg_degree // 2
    keep_ratio = p_in_out_ratio / (1.0 + p_in_out_ratio)
    src_l, dst_l = [], []
    n_have = 0
    while n_have < target_e:
        m = (target_e - n_have) * 3 + 16
        a = rng.integers(0, n_nodes, size=m)
        b = rng.integers(0, n_nodes, size=m)
        same = labels[a] == labels[b]
        u = rng.random(m)
        keep = (a != b) & np.where(same, u < keep_ratio, u < (1 - keep_ratio) * 0.25)
        a, b = a[keep][: target_e - n_have], b[keep][: target_e - n_have]
        src_l.append(a)
        dst_l.append(b)
        n_have += len(a)
    s = np.concatenate(src_l)
    d = np.concatenate(dst_l)
    edges = np.stack([np.concatenate([s, d]), np.concatenate([d, s])]).astype(np.int32)
    # features: class centroid + noise
    cent = rng.normal(size=(n_classes, d_feat)).astype(np.float32)
    feats = cent[labels] + 0.8 * rng.normal(size=(n_nodes, d_feat)).astype(np.float32)
    label_mask = rng.random(n_nodes) < 0.3
    return {"feats": feats, "edges": edges, "labels": labels.astype(np.int32),
            "label_mask": label_mask}


def molecule_batch(batch: int, *, n_nodes: int = 30, n_edges: int = 64,
                   d_feat: int = 16, n_classes: int = 2, seed: int = 0):
    """Packed batch of small random graphs; label = parity of triangle count
    proxy (degree-sum), learnable from structure + features."""
    rng = np.random.default_rng(seed)
    N = batch * n_nodes
    feats = rng.normal(size=(N, d_feat)).astype(np.float32)
    src = np.zeros((batch, n_edges), np.int64)
    dst = np.zeros((batch, n_edges), np.int64)
    labels = np.zeros((batch,), np.int64)
    for g in range(batch):
        a = rng.integers(0, n_nodes, size=n_edges)
        b = rng.integers(0, n_nodes, size=n_edges)
        src[g] = a + g * n_nodes
        dst[g] = b + g * n_nodes
        labels[g] = int(np.unique(a).size > n_nodes * 0.85)
        # plant a feature signal so the task is learnable
        feats[g * n_nodes:(g + 1) * n_nodes, 0] += labels[g] * 1.5
    edges = np.stack([src.reshape(-1), dst.reshape(-1)]).astype(np.int32)
    graph_ids = np.repeat(np.arange(batch), n_nodes).astype(np.int32)
    return {"feats": feats, "edges": edges, "graph_ids": graph_ids,
            "n_graphs": batch, "labels": labels.astype(np.int32)}
