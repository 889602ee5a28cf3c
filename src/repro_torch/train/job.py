"""One training step for every model family, as a ``TrainJob`` (the
reference's ``ArchJob`` step and ``examples/train_sbert.py``'s
``SbertJob`` step are the same step over different losses).

A step is the reference's: the loss and its gradients
(``train.accum.value_and_grad``), ``clip_by_global_norm`` at 1.0,
``cosine_schedule`` and ``adamw_update``. The optimizer runs over the
parameters in the reference's layout (``core.convert.bind_reference_layout``:
each stacked transformer leaf one (L, ...) tensor that the layers'
parameters are views of; a recsys or GNN model's layers in lists), so that
a checkpoint of ``{"params", "opt"}`` has the reference's paths and
leaves, and each package restores the other's. Batches are a function of
the step, so a restart from a checkpoint replays the same steps; on the
card, a bit-equal replay needs ``torch.use_deterministic_algorithms(True)``
(an embedding's or a scatter sum's backward otherwise sums with atomics).
"""
from __future__ import annotations

import time

import torch

from repro_torch.core import convert
from repro_torch.ft.faults import FailureInjector
from repro_torch.ft.supervisor import TrainJob
from repro_torch.train.accum import value_and_grad
from repro_torch.train.optim import (adamw_init, adamw_update,
                                     clip_by_global_norm, cosine_schedule,
                                     tree_get, tree_paths)


CLIP = 1.0            # the reference's CLI and example both clip at 1.0
WEIGHT_DECAY = 0.01   # and decay at adamw_update's default


def to_device(batch: dict, device) -> dict:
    """A batch's arrays as tensors on ``device``; ints and strings pass
    through, lists and dicts (a GNN's blocks) are walked."""
    if isinstance(batch, dict):
        return {k: to_device(v, device) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return [to_device(v, device) for v in batch]
    if isinstance(batch, (int, float, str)) or batch is None:
        return batch
    return torch.as_tensor(batch).to(device)


class ModelJob(TrainJob):
    """``loss(model, batch) -> (loss, metrics)`` trained on ``model`` (on
    its device, trainable) as a ``TrainJob``. ``batch_fn(step)`` gives the
    step's batch (numpy or tensors). ``metrics`` holds each step's metrics
    as floats, ``step_seconds`` each step's host time (synchronized on the
    card), ``saves`` each async checkpoint's handle."""

    def __init__(self, cfg, model, loss, batch_fn, *, lr: float,
                 warmup: int, total_steps: int, int8_state: bool = False,
                 injector=None, log_every: int = 10, log=print):
        self.cfg, self.model, self.loss, self.batch_fn = cfg, model, loss, batch_fn
        self.lr, self.warmup, self.total_steps = lr, warmup, total_steps
        self.int8_state = int8_state
        self.injector = injector or FailureInjector()
        self.device = next(model.parameters()).device
        self.log_every, self.log = log_every, log
        self.params = convert.bind_reference_layout(model, cfg)
        self.opt = adamw_init(self.params, int8_state=int8_state)
        self.metrics, self.step_seconds, self.saves = [], [], []

    @property
    def state(self) -> dict:
        """{"params", "opt"} in the reference's layout (live tensors)."""
        return {"params": self.params, "opt": self.opt}

    def device_batch(self, step: int) -> dict:
        return to_device(self.batch_fn(step), self.device)

    def grads(self, batch):
        """((loss, metrics), gradients in the reference's layout)."""
        (loss, metrics), grads = value_and_grad(self.loss, self.model, batch)
        return (loss, metrics), convert.stack_layers(grads, self.cfg)

    def run_step(self, step: int) -> dict:
        self.injector.check(step)
        t0 = time.perf_counter()
        (_, metrics), grads = self.grads(self.device_batch(step))
        grads, _ = clip_by_global_norm(grads, CLIP)
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
            self.log(f"  step {step:4d}  " + "  ".join(
                f"{k} {v:.4f}" for k, v in sorted(m.items())))
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
