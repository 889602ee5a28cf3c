"""Micro-batch gradient accumulation (port of ``repro.train.accum``).

The reference scans ``jax.value_and_grad`` over micro-batches with a
float32 accumulator; here a Python loop runs the loss and
``torch.autograd.grad`` one micro-batch at a time (peak activation memory
is one micro-batch's), summing into float32 buffers.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.device import float32_bf16_sums, strict_fp32
from repro_torch.train.optim import tree_build, tree_paths


def _grad_leaves(params) -> list:
    """[(path, tensor)] of what the gradient is taken of: a module's
    parameters by name (one-level paths), else the tree's leaves."""
    if isinstance(params, nn.Module):
        return [((name,), p) for name, p in params.named_parameters()]
    return tree_paths(params)


def value_and_grad(loss_fn, params, batch):
    """((loss, metrics), grads) of ``loss_fn(params, batch)``, as
    ``jax.value_and_grad(..., has_aux=True)``. Grads are float32, a tree
    like ``params`` (a module's: {parameter name: grad}); a leaf the loss
    does not reach gets zeros. The forward and the backward both run under
    ``float32_bf16_sums`` and ``strict_fp32``: the backward runs after a
    decorated forward has returned, so the forward's own settings would
    not cover it."""
    leaves = _grad_leaves(params)
    with float32_bf16_sums(), strict_fp32():
        loss, metrics = loss_fn(params, batch)
        got = torch.autograd.grad(loss, [t for _, t in leaves],
                                  allow_unused=True)
    grads = tree_build(
        (path, torch.zeros(t.shape, device=t.device) if g is None else g.float())
        for (path, t), g in zip(leaves, got))
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()}), grads


def gradient_accumulation(loss_fn, params, batch, n_micro: int):
    """Splits every batch leaf's leading axis into ``n_micro`` chunks and
    accumulates. ``loss_fn(params, microbatch) -> (loss, metrics)``.
    Returns (grads, loss, metrics), each the sum over micro-batches times
    1 / n_micro, as the reference scales them; grads as ``value_and_grad``
    gives them."""
    if n_micro <= 1:
        (loss, metrics), grads = value_and_grad(loss_fn, params, batch)
        return grads, loss, metrics
    B = next(iter(batch.values())).shape[0]
    if B % n_micro:
        raise ValueError(f"batch of {B} does not split into {n_micro} "
                         "micro-batches")
    size = B // n_micro
    acc = loss_acc = m_acc = None
    for i in range(n_micro):
        mb = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
        (loss, metrics), grads = value_and_grad(loss_fn, params, mb)
        if acc is None:
            acc, loss_acc, m_acc = dict(tree_paths(grads)), loss, metrics
            continue
        for path, g in tree_paths(grads):
            acc[path] = acc[path] + g
        loss_acc = loss_acc + loss
        m_acc = {k: m_acc[k] + metrics[k] for k in m_acc}
    inv = 1.0 / n_micro
    return (tree_build((path, g * inv) for path, g in acc.items()),
            loss_acc * inv, {k: v * inv for k, v in m_acc.items()})
