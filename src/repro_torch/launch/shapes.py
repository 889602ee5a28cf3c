"""The assigned (architecture x input-shape) grid, 40 cells (port of
``repro.launch.shapes``).

Every cell resolves to a CellSpec: which step program to build (train /
prefill / decode / serve / retrieval / train_*), the abstract inputs and
per-family extras (GNN graph dims, recsys candidate count).
``launch.dryrun`` iterates this table.

Inputs are abstract: a ``Spec`` is a (shape, dtype) pair, the port's
``jax.ShapeDtypeStruct``, which allocates nothing
(``steps.BuiltStep.abstract_args`` makes fake shards of them).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.configs.registry import get_arch


@dataclasses.dataclass(frozen=True)
class Spec:
    """An abstract array: ``shape`` and ``dtype`` (a ``torch.dtype``)."""

    shape: tuple
    dtype: torch.dtype

    def __post_init__(self):
        object.__setattr__(self, "shape", tuple(int(s) for s in self.shape))

    @property
    def ndim(self) -> int:
        return len(self.shape)


SDS = Spec


def pad_up(n: int, mult: int = 512) -> int:
    """Pad a data dimension to a mesh multiple (the shardings demand exact
    divisibility; loaders pad and the pad rows are masked/never indexed)."""
    return -(-n // mult) * mult


# ---------------------------------------------------------------- tables

LM_SHAPES = {
    "train_4k": dict(step="train", seq_len=4096, global_batch=256),
    "prefill_32k": dict(step="prefill", seq_len=32_768, global_batch=32),
    "decode_32k": dict(step="decode", seq_len=32_768, global_batch=128),
    "long_500k": dict(step="decode", seq_len=524_288, global_batch=1),
}

GNN_SHAPES = {
    # cora
    "full_graph_sm": dict(step="train_full", n_nodes=2708, n_edges=10_556,
                          d_feat=1433, n_classes=7),
    # reddit, sampled
    "minibatch_lg": dict(step="train_blocks", n_nodes=232_965,
                         n_edges=114_615_892, batch_nodes=1024,
                         fanout=(15, 10), d_feat=602, n_classes=41),
    # ogbn-products
    "ogb_products": dict(step="train_full", n_nodes=2_449_029,
                         n_edges=61_859_140, d_feat=100, n_classes=47),
    # packed minigraphs
    "molecule": dict(step="train_graphs", n_nodes=30, n_edges=64, batch=128,
                     d_feat=16, n_classes=2),
}

RECSYS_SHAPES = {
    "train_batch": dict(step="train", batch=65_536),
    "serve_p99": dict(step="serve", batch=512),
    "serve_bulk": dict(step="serve", batch=262_144),
    "retrieval_cand": dict(step="retrieval", batch=1, n_candidates=1_000_000),
}

FAMILY_SHAPES = {"lm": LM_SHAPES, "gnn": GNN_SHAPES, "recsys": RECSYS_SHAPES,
                 "encoder": LM_SHAPES}


def shape_ids(family: str):
    return list(FAMILY_SHAPES[family])


def cell_is_skipped(arch_id: str, shape_id: str) -> Optional[str]:
    """Returns a skip reason or None. Skips per the assignment rules."""
    e = get_arch(arch_id)
    if e.family in ("lm", "encoder") and shape_id == "long_500k":
        cfg = e.full
        if cfg.window is None:
            return ("pure full-attention arch: 512k decode cache/attention is "
                    "O(seq); only SWA archs run long_500k (DESIGN.md)")
    return None


def all_cells(include_skipped: bool = False):
    """Every (arch, shape) in the assignment (40 incl. skips)."""
    from repro_torch.configs.registry import ASSIGNED
    out = []
    for a in ASSIGNED:
        fam = get_arch(a).family
        for s in shape_ids(fam):
            skip = cell_is_skipped(a, s)
            if skip is None or include_skipped:
                out.append((a, s))
    return out


# ---------------------------------------------------------------- cell spec


@dataclasses.dataclass
class CellSpec:
    arch_id: str
    shape_id: str
    family: str
    step: str            # train | prefill | decode | serve | retrieval | train_*
    cfg: object          # possibly shape-adjusted config
    inputs: Dict[str, object]  # name -> Spec (or a tree of them)
    meta: Dict           # raw shape table entry


def lm_inputs(cfg, shp) -> Dict:
    B, S = shp["global_batch"], shp["seq_len"]
    i32 = torch.int32
    if shp["step"] == "train":
        return {"tokens": SDS((B, S), i32), "labels": SDS((B, S), i32)}
    if shp["step"] == "prefill":
        return {"tokens": SDS((B, S), i32)}
    # decode: one new token against a seq_len cache
    C = S if cfg.window is None else min(S, cfg.window)
    L = cfg.n_layers
    dt = getattr(torch, cfg.dtype)
    if cfg.mla is not None:
        cache = {"ckv": SDS((L, B, C, cfg.mla.kv_lora_rank), dt),
                 "krope": SDS((L, B, C, cfg.mla.qk_rope_dim), dt)}
    else:
        cache = {"k": SDS((L, B, C, cfg.n_kv_heads, cfg.head_dim), dt),
                 "v": SDS((L, B, C, cfg.n_kv_heads, cfg.head_dim), dt)}
    return {"token": SDS((B, 1), i32), "cache": cache}


def gnn_inputs(cfg, shp) -> Dict:
    from repro_torch.models.gnn import block_static_shapes
    d = shp["d_feat"]
    f32, i32, b = torch.float32, torch.int32, torch.bool
    if shp["step"] == "train_full":
        N, E = pad_up(shp["n_nodes"]), pad_up(2 * shp["n_edges"])
        return {"feats": SDS((N, d), f32),
                "edges": SDS((2, E), i32),  # both directions, padded
                "labels": SDS((N,), i32),
                "label_mask": SDS((N,), b)}
    if shp["step"] == "train_blocks":
        n_in, blocks = block_static_shapes(shp["batch_nodes"], shp["fanout"])
        blk_specs = []
        for blk in blocks:  # static n_dst stays in meta (closed over by steps)
            blk_specs.append({
                "src": SDS((blk["n_edges"],), i32),
                "dst": SDS((blk["n_edges"],), i32),
                "edge_mask": SDS((blk["n_edges"],), b),
                "self_idx": SDS((blk["n_dst"],), i32),
            })
        return {"feats": SDS((n_in, d), f32),
                "blocks": blk_specs,
                "labels": SDS((shp["batch_nodes"],), i32)}
    # packed molecule batch (n_graphs static, in meta)
    B, n, e = shp["batch"], shp["n_nodes"], shp["n_edges"]
    return {"feats": SDS((B * n, d), f32),
            "edges": SDS((2, B * e), i32),
            "graph_ids": SDS((B * n,), i32),
            "labels": SDS((B,), i32)}


def recsys_inputs(cfg, shp) -> Dict:
    B = shp["batch"]
    f32, i32 = torch.float32, torch.int32
    if cfg.kind == "sasrec":
        seq = SDS((B, cfg.seq_len), i32)
        if shp["step"] == "train":
            return {"seq": seq, "pos": seq, "neg": seq}
        if shp["step"] == "retrieval":
            return {"seq": seq,
                    "candidates": SDS((pad_up(shp["n_candidates"]),
                                       cfg.embed_dim), f32)}
        return {"seq": seq}
    base = {"sparse_idx": SDS((B, cfg.n_sparse), i32),
            "dense": SDS((B, cfg.n_dense), f32)}
    if shp["step"] == "train":
        return dict(base, label=SDS((B,), f32))
    if shp["step"] == "retrieval":
        dim = {"fm": cfg.embed_dim + 1, "deepfm": cfg.embed_dim + 1,
               "autoint": cfg.d_attn * cfg.n_attn_heads}[cfg.kind]
        return dict(base, candidates=SDS((pad_up(shp["n_candidates"]), dim),
                                         f32))
    return base


def get_cell(arch_id: str, shape_id: str, *, smoke: bool = False) -> CellSpec:
    e = get_arch(arch_id)
    shp = dict(FAMILY_SHAPES[e.family][shape_id])
    cfg = e.smoke if smoke else e.full
    if e.family == "gnn":
        cfg = dataclasses.replace(cfg, d_in=shp["d_feat"],
                                  n_classes=shp["n_classes"])
        inputs = gnn_inputs(cfg, shp)
    elif e.family == "recsys":
        inputs = recsys_inputs(cfg, shp)
    else:
        inputs = lm_inputs(cfg, shp)
    return CellSpec(arch_id, shape_id, e.family, shp["step"], cfg, inputs, shp)
