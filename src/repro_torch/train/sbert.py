"""Train the encoder with the siamese contrastive objective, then measure
retrieval with the trained tower (port of ``examples/train_sbert.py``'s
``SbertJob`` and ``retrieval_accuracy``; kept in the package so that the
trainer CLI, the tests and ``chip_smoke.py`` share one loop).

The step is ``train.job.ModelJob``'s over ``contrastive_loss``: clip 1.0,
the cosine schedule and AdamW over the reference's layout.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import encoder as enc_lib
from repro_torch.train.job import ModelJob


class EncoderJob(ModelJob):
    """The encoder's contrastive training as a ``TrainJob``.

    ``batch_fn(step)`` -> {"q_tokens", "p_tokens"[, "q_mask", "p_mask"]}
    (numpy or tensors). Parameters come from ``torch.Generator().
    manual_seed(seed)`` on the host, then move to ``device`` (the card
    unless "cpu"), so a seed gives the same state on either. ``metrics``
    holds each step's {"loss", "in_batch_acc"}."""

    def __init__(self, cfg, batch_fn, *, lr: float = 3e-4, warmup: int = 20,
                 total_steps: int = 200, int8_state: bool = False,
                 injector=None, device=None, seed: int = 0,
                 log_every: int = 20, log=print):
        model = enc_lib.init(cfg, torch.Generator().manual_seed(seed),
                             device=resolve_device(device), trainable=True)
        super().__init__(
            cfg, model,
            lambda m, batch: enc_lib.contrastive_loss(m, cfg, batch),
            batch_fn, lr=lr, warmup=warmup, total_steps=total_steps,
            int8_state=int8_state, injector=injector, log_every=log_every,
            log=log)


def sbert_batches(data, batch: int, vocab_size: int, seq_len: int = 24):
    """examples/train_sbert.py's batch of a step: ``batch`` passages drawn
    by ``np.random.default_rng(step)``, each with its query (zero-padded to
    ``seq_len``), tokens taken mod the vocabulary, masks where non-zero."""
    queries = data.queries()  # a function of the data's seed: computed once

    def batch_fn(step: int) -> dict:
        rng = np.random.default_rng(step)
        idx = rng.integers(0, data.n_passages, size=batch)
        q = np.zeros((batch, seq_len), np.int32)
        q[:, : data.query_len] = queries[idx]
        p = data.passages[idx][:, :seq_len]
        return {"q_tokens": q % vocab_size, "q_mask": q != 0,
                "p_tokens": p % vocab_size, "p_mask": p != 0}

    return batch_fn


class SbertJob(EncoderJob):
    """examples/train_sbert.py's job: MarcoLike pairs at seq_len 24,
    AdamW lr 3e-4 (cosine, warmup 20), clip 1.0, weight decay 0.01."""

    def __init__(self, cfg, data, batch: int, injector=None, lr: float = 3e-4,
                 total_steps: int = 200, **kw):
        self.data = data
        super().__init__(cfg, sbert_batches(data, batch, cfg.vocab_size),
                         lr=lr, warmup=20, total_steps=total_steps,
                         injector=injector, **kw)


def embed_rows(model, cfg, tok_rows, chunk: int = 128, seq_len: int = 24):
    """examples/train_sbert.py's ``embed``: rows cut to ``seq_len``, mod
    the vocabulary, in zero-padded chunks of ``chunk`` rows, mask where
    non-zero, through ``encode`` (the attention kernel on the card)."""
    out = []
    for i in range(0, len(tok_rows), chunk):
        rows = np.asarray(tok_rows[i:i + chunk])[:, :seq_len] % cfg.vocab_size
        if len(rows) < chunk:
            rows = np.pad(rows, ((0, chunk - len(rows)), (0, 0)))
        tok = torch.as_tensor(rows)
        out.append(enc_lib.encode(model, cfg, tok, tok != 0))
    return torch.cat(out)[: len(tok_rows)]


def retrieval_accuracy(model, cfg, data, n_eval: int = 300, *, stats=None):
    """Top-1 accuracy of each of the first ``n_eval`` queries finding its
    own passage, through ``VectorDB("flat", metric="cosine")`` on the
    model's device (the ``topk_distance`` kernel on the card).
    ``stats`` (a dict) gains the encode and search seconds."""
    from repro_torch.core.db import VectorDB
    dev = model.embed.table.device
    t0 = time.perf_counter()
    p_emb = embed_rows(model, cfg, data.passages)
    qs = np.zeros((data.n_passages, 24), np.int32)
    qs[:, : data.query_len] = data.queries()
    q_emb = embed_rows(model, cfg, qs)[:n_eval]
    t1 = time.perf_counter()
    db = VectorDB("flat", metric="cosine", device=dev).load(p_emb)
    _, ids = db.query(q_emb, k=1)
    acc = float((ids[:, 0].cpu() == torch.arange(n_eval)).float().mean())
    if stats is not None:
        stats.update(encode_s=t1 - t0, search_s=time.perf_counter() - t1)
    return acc
