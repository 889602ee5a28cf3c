"""Train the encoder with the siamese contrastive objective, then measure
retrieval with the trained tower (port of ``examples/train_sbert.py``'s
``SbertJob`` and ``retrieval_accuracy``; kept in the package so that the
trainer CLI, the tests and ``chip_smoke.py`` share one loop).

A step is the reference's: ``contrastive_loss`` and its gradients
(``train.accum.value_and_grad``), ``clip_by_global_norm`` at 1.0,
``cosine_schedule`` and ``adamw_update``. The optimizer runs over the
parameters in the reference's layout (``core.convert.bind_reference_layout``:
each ``dense_blocks`` leaf one (L, ...) tensor that the layers' parameters
are views of), so that a checkpoint of ``{"params", "opt"}`` has the
reference's paths and leaves, and each package restores the other's.
Batches are a function of the step, so a restart from a checkpoint replays
the same steps; on the card, a bit-equal replay needs
``torch.use_deterministic_algorithms(True)`` (the embedding's backward
otherwise sums with atomics).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core import convert
from repro_torch.device import resolve_device
from repro_torch.ft.faults import FailureInjector
from repro_torch.ft.supervisor import TrainJob
from repro_torch.models import encoder as enc_lib
from repro_torch.train.accum import value_and_grad
from repro_torch.train.optim import (adamw_init, adamw_update,
                                     clip_by_global_norm, cosine_schedule,
                                     tree_get, tree_paths)


CLIP = 1.0            # the reference's CLI and example both clip at 1.0
WEIGHT_DECAY = 0.01   # and decay at adamw_update's default


class EncoderJob(TrainJob):
    """The encoder's contrastive training as a ``TrainJob``.

    ``batch_fn(step)`` -> {"q_tokens", "p_tokens"[, "q_mask", "p_mask"]}
    (numpy or tensors). Parameters come from ``torch.Generator().
    manual_seed(seed)`` on the host, then move to ``device`` (the card
    unless "cpu"), so a seed gives the same state on either. ``metrics``
    holds each step's {"loss", "in_batch_acc"}, ``step_seconds`` each
    step's host time (synchronized on the card), ``saves`` each async
    checkpoint's handle."""

    def __init__(self, cfg, batch_fn, *, lr: float = 3e-4, warmup: int = 20,
                 total_steps: int = 200, int8_state: bool = False,
                 injector=None, device=None, seed: int = 0,
                 log_every: int = 20, log=print):
        self.cfg, self.batch_fn = cfg, batch_fn
        self.lr, self.warmup, self.total_steps = lr, warmup, total_steps
        self.int8_state = int8_state
        self.injector = injector or FailureInjector()
        self.device = resolve_device(device)
        self.log_every, self.log = log_every, log
        self.model = enc_lib.init(cfg, torch.Generator().manual_seed(seed),
                                  device=self.device, trainable=True)
        self.params = convert.bind_reference_layout(self.model, cfg)
        self.opt = adamw_init(self.params, int8_state=int8_state)
        self.metrics, self.step_seconds, self.saves = [], [], []

    @property
    def state(self) -> dict:
        """{"params", "opt"} in the reference's layout (live tensors)."""
        return {"params": self.params, "opt": self.opt}

    def device_batch(self, step: int) -> dict:
        return {k: torch.as_tensor(v).to(self.device)
                for k, v in self.batch_fn(step).items()}

    def run_step(self, step: int) -> dict:
        self.injector.check(step)
        t0 = time.perf_counter()
        (_, metrics), grads = value_and_grad(
            lambda model, batch: enc_lib.contrastive_loss(model, self.cfg,
                                                          batch),
            self.model, self.device_batch(step))
        grads, _ = clip_by_global_norm(convert.stack_layers(grads, self.cfg),
                                       CLIP)
        lr = cosine_schedule(self.opt["step"], base_lr=self.lr,
                             warmup=self.warmup, total=self.total_steps)
        new_params, self.opt = adamw_update(
            grads, self.opt, self.params, lr=lr, weight_decay=WEIGHT_DECAY,
            int8_state=self.int8_state)
        self.set_params(new_params)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.step_seconds.append(time.perf_counter() - t0)
        m = {k: float(v) for k, v in metrics.items()}
        self.metrics.append(m)
        if self.log_every and step % self.log_every == 0:
            self.log(f"  step {step:4d}  loss {m['loss']:.4f}  "
                     f"in-batch acc {m['in_batch_acc']:.3f}")
        return m

    @torch.no_grad()
    def set_params(self, tree) -> None:
        """Write a reference-layout tree into the model's parameters."""
        for path, leaf in tree_paths(self.params):
            leaf.copy_(tree_get(tree, path))

    def save_state(self, store, step: int):
        # save_async copies every leaf to the host before it returns, so the
        # next step cannot change a tensor that is still being written
        self.saves.append(store.save_async(self.state, step))

    def load_state(self, store):
        store.wait()  # a save still in flight is the newest checkpoint
        step = store.latest_step()
        if step is None:
            return None
        state, _ = store.restore(self.state, step)
        self.set_params(state["params"])
        self.opt = state["opt"]
        return step

    def remesh(self, scale):
        return self  # one device: the elastic path is exercised in tests


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
