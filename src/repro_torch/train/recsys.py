"""Serve a trained recsys model's retrieval through ``VectorDB`` (the
port of ``examples/recsys_retrieval.py``'s path, kept in the package so
that the tests and ``chip_smoke.py`` share it; the model trains through
the trainer CLI's job, ``launch.train.ArchJob``, or ``train.job.ModelJob``
over ``recsys.loss_fn``).

Retrieval decomposes the model
into towers (``models.recsys``): the item tower's vectors load into
``VectorDB("flat", metric="dot")`` on the model's device (the
``topk_distance`` kernel on the card; the engine pads d = 11 and 50 to
the kernel's width), and the user tower's vectors query it. For FM the
decomposition is exact: the MIPS top item is the argmax of ``fm_forward``
re-scored over every item (``fm_rescore``).
"""
from __future__ import annotations

import torch

from repro_torch.models import recsys as rec_lib

ITEM_FIELD = 0   # the example's item field: the largest table


def n_items(cfg, item_field: int = ITEM_FIELD) -> int:
    """The item corpus's rows: the item field's vocabulary, or SASRec's
    whole item table (padding rows included)."""
    if cfg.kind == "sasrec":
        return -(-(cfg.n_items + 1) // 1024) * 1024
    return int(cfg.field_vocab_sizes()[item_field])


@torch.no_grad()
def item_vectors(model, cfg, item_field: int = ITEM_FIELD,
                 chunk: int = 1 << 20):
    """(items, d) float32 on the model's device: FM's and DeepFM's
    [v_i ; w_i] (d = embed_dim + 1), AutoInt's interacted item embeddings,
    SASRec's item table; a chunk of items at a time."""
    if cfg.kind == "sasrec":  # a copy: the engine must not alias the table
        return rec_lib.sasrec_item_vectors(model).detach().clone()
    dev = model.tables.embed.device
    tower = (rec_lib.autoint_item_vectors if cfg.kind == "autoint"
             else rec_lib.fm_item_vectors)
    n = n_items(cfg, item_field)
    return torch.cat([tower(model, cfg, torch.arange(a, min(a + chunk, n),
                                                     device=dev), item_field)
                      for a in range(0, n, chunk)])


@torch.no_grad()
def user_vectors(model, cfg, batch, item_field: int = ITEM_FIELD):
    """(B, d) float32 query vectors for a batch's users."""
    if cfg.kind == "sasrec":
        return rec_lib.sasrec_user_vector(model, cfg, batch["seq"])
    if cfg.kind == "autoint":
        return rec_lib.autoint_user_vector(model, cfg, batch, item_field)
    return rec_lib.fm_user_vector(model, cfg, batch, item_field)


def retrieval_db(model, cfg, item_field: int = ITEM_FIELD):
    """The item tower loaded into ``VectorDB("flat", metric="dot")`` on
    the model's device."""
    from repro_torch.core.db import VectorDB
    vecs = item_vectors(model, cfg, item_field)
    return VectorDB("flat", metric="dot", device=vecs.device).load(vecs)


@torch.no_grad()
def fm_rescore(model, cfg, batch, item_field: int = ITEM_FIELD,
               chunk: int = 1 << 20):
    """(B, items) ``fm_forward`` of each user's row with the item field set
    to every item in turn: the full model, a chunk of items at a time."""
    off = int(rec_lib.field_offsets(cfg)[item_field])
    dev = model.tables.embed.device
    n = n_items(cfg, item_field)
    rows = []
    for u in range(batch["sparse_idx"].shape[0]):
        parts = []
        for a in range(0, n, chunk):
            ids = torch.arange(a, min(a + chunk, n), device=dev)
            sp = batch["sparse_idx"][u:u + 1].expand(ids.shape[0], -1).clone()
            sp[:, item_field] = ids + off
            one = {"sparse_idx": sp,
                   "dense": batch["dense"][u:u + 1].expand(ids.shape[0], -1)}
            parts.append(rec_lib.fm_forward(model, cfg, one))
        rows.append(torch.cat(parts))
    return torch.stack(rows)
