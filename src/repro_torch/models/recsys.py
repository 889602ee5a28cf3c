"""Recsys towers: FM, DeepFM, AutoInt, SASRec (port of
``repro.models.recsys``).

The hot path is the sparse embedding lookup. ``embedding_bag`` is the
CSR form (flat row ids and a bag id each: a gather, then ``index_add``
into the bags, mean or sum); the models take the dense single-valued
form, one row a field, (B, F) ids -> (B, F, d) (``lookup_fields``).
Every lookup is ``F.embedding``: its backward sums a repeated id's
gradients in parallel, where an indexing gather's backward adds them one
after another (1.8 s of a 2.0 s SASRec step at 65,536 x 50 positions,
whose padding id repeats about 800,000 times, on an H100). All
Criteo-like fields live in ONE unified table;
``field_offsets`` maps field-local ids to unified rows. The table's
gradient is dense, as the reference's is (``jnp.take``'s transpose is a
dense scatter-add), so AdamW with weight decay moves every row.

Retrieval is served through ``VectorDB`` by exact dot-product
decompositions: FM's score(u, i) = const(u) + w_i + <sum_f v_f, v_i>
-> user vector [sum_v ; 1], item vector [v_i ; w_i], pure MIPS; SASRec's
user vector is the last valid hidden state and its item vectors the item
embeddings; AutoInt's self-attention is not dot-decomposable, so its
towers are the reference's two-tower approximation (the user's fields
interacted alone and mean-pooled; each item's embedding through the
interaction layers alone).

Each model is an ``nn.Module`` whose ``named_parameters`` are the
reference's tree paths, its lists (DeepFM's ``mlp``, AutoInt's ``attn``,
SASRec's ``blocks``) as ``ModuleList``s: ``core.convert`` carries trees
both ways.

    init(cfg, generator, device=None, trainable=False) -> model
    forward(params, cfg, batch)                       -> CTR logit (B,)
    loss_fn(params, cfg, batch)                       -> (loss, metrics)
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import RecsysConfig
from repro_torch.device import resolve_device
from repro_torch.models.layers import (Norm, apply_norm, dense_init, embedding,
                                       log_sigmoid, trunc_normal)


# ============================================================ embedding bag


def field_offsets(cfg: RecsysConfig) -> np.ndarray:
    """Start row of each field in the unified table; shape (n_sparse + 1,)."""
    sizes = np.asarray(cfg.field_vocab_sizes(), np.int64)
    return np.concatenate([[0], np.cumsum(sizes)])


def embedding_bag(table, idx, bag_ids, n_bags: int, *, mode: str = "sum",
                  valid=None):
    """CSR-style EmbeddingBag: gather rows then sum them into bags.

    table: (V, d); idx: (nnz,) row ids; bag_ids: (nnz,) target bag per index
    (non-decreasing not required); valid: optional (nnz,) bool. An empty
    bag is zeros (its mean too)."""
    rows = embedding(idx.long(), table)
    if valid is not None:
        rows = torch.where(valid[:, None], rows, 0.0)
    bag_ids = bag_ids.long()
    out = rows.new_zeros((n_bags, rows.shape[1])).index_add(0, bag_ids, rows)
    if mode == "mean":
        ones = torch.ones(idx.shape[0], dtype=rows.dtype, device=rows.device)
        if valid is not None:
            ones = ones * valid.to(rows.dtype)
        cnt = ones.new_zeros(n_bags).index_add(0, bag_ids, ones)
        out = out / torch.clamp(cnt, min=1.0)[:, None]
    return out


def lookup_fields(table, sparse_idx, dtype):
    """Dense single-valued-per-field lookup: (B, F) unified ids -> (B, F, d)."""
    return embedding(sparse_idx.long(), table).to(dtype)


# ============================================================ parameters


class Tables(nn.Module):
    """The unified table ``embed`` (V, d) and first-order weights ``w1``
    (V, 1), both std 0.01."""

    def __init__(self, generator, cfg: RecsysConfig, dtype):
        super().__init__()
        V = int(sum(cfg.field_vocab_sizes()))
        self.embed = trunc_normal((V, cfg.embed_dim), 0.01, generator, dtype)
        self.w1 = trunc_normal((V, 1), 0.01, generator, dtype)


class DenseProj(nn.Module):
    """Dense features enter as one synthetic field each: value * ``v``
    (n_dense, d); first-order weights ``w`` (n_dense,), zeros."""

    def __init__(self, generator, cfg: RecsysConfig, dtype):
        super().__init__()
        self.v = trunc_normal((cfg.n_dense, cfg.embed_dim), 0.01, generator,
                              dtype)
        self.w = nn.Parameter(torch.zeros(cfg.n_dense, dtype=dtype,
                                          device=generator.device))


class Linear(nn.Module):
    """``w`` (d_in, d_out), fan-in scaled, and ``b`` (d_out,), zeros; or
    ``w`` alone (``bias=False``)."""

    def __init__(self, generator, d_in: int, d_out: int, dtype,
                 bias: bool = True):
        super().__init__()
        self.w = dense_init(generator, d_in, d_out, dtype)
        if bias:
            self.b = nn.Parameter(torch.zeros(d_out, dtype=dtype,
                                              device=generator.device))


def _bias(generator, dtype):
    return nn.Parameter(torch.zeros((), dtype=dtype, device=generator.device))


def _mlp(generator, dims, dtype) -> nn.ModuleList:
    return nn.ModuleList(Linear(generator, dims[i], dims[i + 1], dtype)
                         for i in range(len(dims) - 1))


def _apply_mlp(layers, x, act=F.relu, final_act=False):
    for i, layer in enumerate(layers):
        x = x @ layer.w.to(x.dtype) + layer.b.to(x.dtype)
        if final_act or i < len(layers) - 1:
            x = act(x)
    return x


class FM(nn.Module):
    """``tables``, ``dense`` and a scalar ``bias``; DeepFM adds ``mlp``."""

    def __init__(self, generator, cfg: RecsysConfig, dtype, deep: bool = False):
        super().__init__()
        self.tables = Tables(generator, cfg, dtype)
        self.dense = DenseProj(generator, cfg, dtype)
        if deep:
            d_in = (cfg.n_sparse + cfg.n_dense) * cfg.embed_dim
            self.mlp = _mlp(generator, (d_in,) + tuple(cfg.mlp_dims) + (1,),
                            dtype)
        self.bias = _bias(generator, dtype)


class AttnLayer(nn.Module):
    """One AutoInt interaction layer: ``wq``, ``wk``, ``wv`` (d_prev, H,
    d_attn) and the residual ``w_res`` (d_prev, H d_attn)."""

    def __init__(self, generator, d_prev: int, cfg: RecsysConfig, dtype):
        super().__init__()
        hk = (cfg.n_attn_heads, cfg.d_attn)
        self.wq = dense_init(generator, d_prev, hk, dtype)
        self.wk = dense_init(generator, d_prev, hk, dtype)
        self.wv = dense_init(generator, d_prev, hk, dtype)
        self.w_res = dense_init(generator, d_prev,
                                cfg.n_attn_heads * cfg.d_attn, dtype)


class AutoInt(nn.Module):
    """``tables``, ``dense``, ``attn`` (a list of ``AttnLayer``), ``head``
    (``w`` (F d_out, 1)) and ``bias``."""

    def __init__(self, generator, cfg: RecsysConfig, dtype):
        super().__init__()
        n_fields = cfg.n_sparse + cfg.n_dense
        self.tables = Tables(generator, cfg, dtype)
        self.dense = DenseProj(generator, cfg, dtype)
        layers, d_prev = [], cfg.embed_dim
        for _ in range(cfg.n_attn_layers):
            layers.append(AttnLayer(generator, d_prev, cfg, dtype))
            d_prev = cfg.d_attn * cfg.n_attn_heads
        self.attn = nn.ModuleList(layers)
        self.head = Linear(generator, n_fields * d_prev, 1, dtype, bias=False)
        self.bias = _bias(generator, dtype)


class SASRecBlock(nn.Module):
    """``norm1``, ``wq``, ``wk``, ``wv``, ``wo`` (d, d), ``norm2``, ``ff1``
    and ``ff2`` (d, d with a bias); LayerNorms."""

    def __init__(self, generator, d: int, dtype):
        super().__init__()
        dev = generator.device
        self.norm1 = Norm("layernorm", d, dtype, dev)
        self.wq = dense_init(generator, d, d, dtype)
        self.wk = dense_init(generator, d, d, dtype)
        self.wv = dense_init(generator, d, d, dtype)
        self.wo = dense_init(generator, d, d, dtype)
        self.norm2 = Norm("layernorm", d, dtype, dev)
        self.ff1 = Linear(generator, d, d, dtype)
        self.ff2 = Linear(generator, d, d, dtype)


class SASRec(nn.Module):
    """``item_embed`` (rows, d; row 0 the padding item, rows padded to a
    multiple of 1,024 that is never indexed), ``pos_embed`` (seq_len, d),
    both std 0.02, ``blocks`` and ``final_norm``."""

    def __init__(self, generator, cfg: RecsysConfig, dtype):
        super().__init__()
        d = cfg.embed_dim
        n_rows = -(-(cfg.n_items + 1) // 1024) * 1024
        self.item_embed = trunc_normal((n_rows, d), 0.02, generator, dtype)
        self.pos_embed = trunc_normal((cfg.seq_len, d), 0.02, generator, dtype)
        self.blocks = nn.ModuleList(SASRecBlock(generator, d, dtype)
                                    for _ in range(cfg.n_blocks))
        self.final_norm = Norm("layernorm", d, dtype, generator.device)


def init(cfg: RecsysConfig, generator: torch.Generator, device=None, *,
         trainable: bool = False) -> nn.Module:
    """The ``cfg.kind`` model, each leaf drawn from ``generator`` on its
    device in ``param_dtype``, then moved to ``device`` (the card unless
    given ``device="cpu"``; without a card, None raises before anything is
    drawn). Frozen unless ``trainable``."""
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.param_dtype)
    make = {"fm": lambda: FM(generator, cfg, dtype),
            "deepfm": lambda: FM(generator, cfg, dtype, deep=True),
            "autoint": lambda: AutoInt(generator, cfg, dtype),
            "sasrec": lambda: SASRec(generator, cfg, dtype)}[cfg.kind]
    return make().to(dev).requires_grad_(trainable)


# ============================================================ FM, DeepFM


def fm_second_order(v):
    """Pairwise sum via the O(nk) sum-square trick [Rendle ICDM'10].

    v: (..., F, d) per-field embeddings -> (...,) scalar
    sum_{i<j} <v_i, v_j> = 0.5 * (|sum_i v_i|^2 - sum_i |v_i|^2).
    """
    s = v.sum(dim=-2)
    sq = torch.square(v).sum(dim=(-2, -1))
    return 0.5 * (torch.square(s).sum(dim=-1) - sq)


def _field_vectors(params, cfg: RecsysConfig, batch, dtype):
    """All per-field embedding vectors (sparse + dense-as-field): (B, F+Fd, d)
    and first-order term (B,)."""
    t = params.tables
    idx = batch["sparse_idx"].long()
    v_sp = lookup_fields(t.embed, idx, dtype)  # (B, F, d)
    first = embedding(idx, t.w1)[..., 0].to(dtype).sum(dim=-1)
    vs = [v_sp]
    if batch.get("dense") is not None and cfg.n_dense:
        dn = batch["dense"].to(dtype)  # (B, Fd)
        d = params.dense
        vs.append(dn[..., None] * d.v.to(dtype)[None])  # (B, Fd, d)
        first = first + dn @ d.w.to(dtype)
    return torch.cat(vs, dim=1), first


def fm_forward(params, cfg: RecsysConfig, batch):
    dtype = getattr(torch, cfg.dtype)
    v, first = _field_vectors(params, cfg, batch, dtype)
    logit = params.bias.float() + first.float()
    return logit + fm_second_order(v.float())


def deepfm_forward(params, cfg: RecsysConfig, batch):
    dtype = getattr(torch, cfg.dtype)
    v, first = _field_vectors(params, cfg, batch, dtype)
    B = v.shape[0]
    logit = params.bias.float() + first.float()
    logit = logit + fm_second_order(v.float())
    deep = _apply_mlp(params.mlp, v.reshape(B, -1))
    return logit + deep[..., 0].float()


# ============================================================ AutoInt


def _autoint_interact(layers, v):
    """Stacked multi-head self-attention over the field axis. v: (B, F, d).
    Scores are float32 (the reference's ``preferred_element_type``)."""
    for layer in layers:
        dt = v.dtype
        q = torch.einsum("bfd,dhk->bfhk", v, layer.wq.to(dt))
        k = torch.einsum("bfd,dhk->bfhk", v, layer.wk.to(dt))
        w = torch.einsum("bfd,dhk->bfhk", v, layer.wv.to(dt))
        s = torch.einsum("bfhk,bghk->bhfg", q.float(), k.float())
        p = torch.softmax(s, dim=-1).to(dt)
        o = torch.einsum("bhfg,bghk->bfhk", p, w)
        B, n_fields = v.shape[:2]
        o = o.reshape(B, n_fields, -1)
        v = F.relu(o + v @ layer.w_res.to(dt))
    return v


def autoint_forward(params, cfg: RecsysConfig, batch):
    dtype = getattr(torch, cfg.dtype)
    v, first = _field_vectors(params, cfg, batch, dtype)
    B = v.shape[0]
    h = _autoint_interact(params.attn, v)
    logit = (h.reshape(B, -1) @ params.head.w.to(dtype))[..., 0]
    return logit.float() + first.float() + params.bias.float()


# ============================================================ SASRec


def sasrec_hidden(params, cfg: RecsysConfig, seq):
    """seq: (B, S) item ids (0 = pad) -> hidden states (B, S, d)."""
    dtype = getattr(torch, cfg.dtype)
    B, S = seq.shape
    seq = seq.long()
    h = embedding(seq, params.item_embed).to(dtype)
    h = h * math.sqrt(cfg.embed_dim) + params.pos_embed[:S].to(dtype)[None]
    pad = seq == 0  # (B, S)
    h = torch.where(pad[..., None], 0.0, h)
    H = cfg.n_attn_heads or 1
    dh = cfg.embed_dim // H
    causal = torch.tril(torch.ones((S, S), dtype=torch.bool,
                                   device=seq.device))
    mask = causal[None, None] & ~pad[:, None, None, :]
    for blk in params.blocks:
        x = apply_norm(blk.norm1, h)
        q = (x @ blk.wq.to(dtype)).reshape(B, S, H, dh)
        k = (x @ blk.wk.to(dtype)).reshape(B, S, H, dh)
        v = (x @ blk.wv.to(dtype)).reshape(B, S, H, dh)
        s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(dh)
        s = torch.where(mask, s, -1e30)
        p = torch.softmax(s, dim=-1).to(dtype)
        o = torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(B, S, -1)
        h = h + o @ blk.wo.to(dtype)
        x = apply_norm(blk.norm2, h)
        y = F.relu(x @ blk.ff1.w.to(dtype) + blk.ff1.b.to(dtype))
        h = h + y @ blk.ff2.w.to(dtype) + blk.ff2.b.to(dtype)
        h = torch.where(pad[..., None], 0.0, h)
    return apply_norm(params.final_norm, h)


def sasrec_loss(params, cfg: RecsysConfig, batch):
    """BCE next-item loss with sampled negatives [arXiv:1808.09781].

    batch: {"seq": (B,S), "pos": (B,S) next item (0=ignore), "neg": (B,S)}.
    """
    h = sasrec_hidden(params, cfg, batch["seq"])
    emb = params.item_embed.to(h.dtype)
    pos, neg = batch["pos"].long(), batch["neg"].long()
    pos_s = (h * embedding(pos, emb)).sum(dim=-1).float()
    neg_s = (h * embedding(neg, emb)).sum(dim=-1).float()
    valid = pos != 0
    nll = -(log_sigmoid(pos_s) + log_sigmoid(-neg_s))
    denom = torch.clamp(valid.sum(), min=1)
    loss = torch.where(valid, nll, 0.0).sum() / denom
    acc = (valid & (pos_s > neg_s)).sum() / denom
    return loss, {"loss": loss, "pairwise_acc": acc}


# ============================================================ unified API


def forward(params, cfg: RecsysConfig, batch):
    """CTR logit (B,) for fm/deepfm/autoint; SASRec scores its own loss."""
    return {"fm": fm_forward, "deepfm": deepfm_forward,
            "autoint": autoint_forward}[cfg.kind](params, cfg, batch)


def bce_loss(params, cfg: RecsysConfig, batch):
    logit = forward(params, cfg, batch)
    y = batch["label"].float()
    nll = (torch.clamp(logit, min=0) - logit * y
           + torch.log1p(torch.exp(-logit.abs())))
    loss = nll.mean()
    acc = ((logit > 0) == (y > 0.5)).float().mean()
    return loss, {"loss": loss, "acc": acc}


def loss_fn(params, cfg: RecsysConfig, batch):
    if cfg.kind == "sasrec":
        return sasrec_loss(params, cfg, batch)
    return bce_loss(params, cfg, batch)


# ============================================================ retrieval towers


def _not_item(cfg_fields: int, item_field: int, device):
    return torch.arange(cfg_fields, device=device) != item_field


def fm_item_vectors(params, cfg: RecsysConfig, item_ids, item_field: int):
    """MIPS item vectors [v_i ; w_i] for the FM dot decomposition.

    item_ids: (N,) field-local ids for `item_field`."""
    rows = item_ids.long() + int(field_offsets(cfg)[item_field])
    t = params.tables
    return torch.cat([t.embed[rows], t.w1[rows]], dim=-1).float()


def fm_user_vector(params, cfg: RecsysConfig, batch, item_field: int):
    """MIPS query vector [sum_f v_f ; 1] over all non-item fields."""
    dtype = getattr(torch, cfg.dtype)
    v, _ = _field_vectors(params, cfg, batch, dtype)
    keep = _not_item(v.shape[1], item_field, v.device)
    s = torch.where(keep[None, :, None], v, 0.0).sum(dim=1)
    ones = torch.ones(s.shape[:-1] + (1,), dtype=s.dtype, device=s.device)
    return torch.cat([s, ones], dim=-1).float()


def sasrec_user_vector(params, cfg: RecsysConfig, seq):
    """Last valid hidden state per sequence -> (B, d) float32."""
    h = sasrec_hidden(params, cfg, seq)
    last = torch.clamp((seq != 0).sum(dim=1) - 1, min=0)
    return h[torch.arange(h.shape[0], device=h.device), last].float()


def sasrec_item_vectors(params):
    return params.item_embed.float()


def autoint_user_vector(params, cfg: RecsysConfig, batch, item_field: int):
    """Two-tower approximation: interact user fields only, mean-pool."""
    dtype = getattr(torch, cfg.dtype)
    v, _ = _field_vectors(params, cfg, batch, dtype)
    keep = _not_item(v.shape[1], item_field, v.device)
    h = _autoint_interact(params.attn, torch.where(keep[None, :, None], v, 0.0))
    return h.mean(dim=1).float()


def autoint_item_vectors(params, cfg: RecsysConfig, item_ids, item_field: int):
    rows = item_ids.long() + int(field_offsets(cfg)[item_field])
    v = params.tables.embed[rows][:, None, :]
    h = _autoint_interact(params.attn, v.to(getattr(torch, cfg.dtype)))
    return h[:, 0].float()
