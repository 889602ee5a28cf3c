"""SBERT-style sentence encoder, the paper's embedding model (port of
``repro.models.encoder``).

A bidirectional transformer (EncoderConfig.causal=False) with the paper's
three pooling options (CLS / mean / max-over-time), an optional projection
and L2 normalization, and the siamese contrastive objective that trains it
(tied weights, in-batch softmax over cosine similarities) [Reimers &
Gurevych 2019].

    model = init(cfg, torch.Generator().manual_seed(0))   # on the card
    emb = encode(model, cfg, tokens, mask)                 # (B, E) float32
    loss, metrics = contrastive_loss(model, cfg, batch)    # with a graph
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import EncoderConfig
from repro_torch.device import float32_bf16_sums, resolve_device
from repro_torch.models import transformer
from repro_torch.models.layers import dense_init


class Projection(nn.Module):
    """``w`` (d_model, project_dim)."""

    def __init__(self, generator, d_in: int, d_out: int, dtype=torch.float32):
        super().__init__()
        self.w = dense_init(generator, d_in, d_out, dtype)


class Encoder(transformer.Transformer):
    """The transformer's parameters plus ``proj`` when ``project_dim``."""

    def __init__(self, cfg: EncoderConfig, generator: torch.Generator):
        super().__init__(cfg, generator)
        if cfg.project_dim:
            self.proj = Projection(generator, cfg.d_model, cfg.project_dim,
                                   getattr(torch, cfg.param_dtype))
        else:
            self.proj = None


def init(cfg: EncoderConfig, generator: torch.Generator, device=None, *,
         trainable: bool = False) -> Encoder:
    """Parameters drawn from ``generator`` on its device, then moved to
    ``device``: the card unless given ``device="cpu"`` (without a card,
    None raises). Frozen for serving unless ``trainable``."""
    model = Encoder(cfg, generator).to(resolve_device(device))
    return model.requires_grad_(trainable)


@float32_bf16_sums()
def encode(params: Encoder, cfg: EncoderConfig, tokens, mask=None, *,
           use_kernel=None, train: bool = False, remat: bool = False):
    """tokens (B, S) -> embeddings (B, E) float32 (L2-normalized if
    cfg.normalize), on the parameters' device. ``use_kernel=False`` runs
    the attention's plain versions on the card as well. bf16 products are
    summed in float32 whatever the caller's cuBLAS setting
    (``device.float32_bf16_sums``). Without a graph unless ``train``,
    which takes the differentiable attention rule (``transformer.forward``)."""
    dev = params.embed.table.device
    tokens = torch.as_tensor(tokens, device=dev)
    if mask is not None:
        mask = torch.as_tensor(mask, dtype=torch.bool, device=dev)
    with contextlib.nullcontext() if train else torch.no_grad():
        out = transformer.embed_pooled(params, cfg, tokens, mask,
                                       use_kernel=use_kernel, train=train,
                                       remat=remat)
        if cfg.project_dim:
            out = out @ params.proj.w.to(out.dtype)
        if cfg.normalize:
            out = out / torch.clamp(
                torch.linalg.vector_norm(out, dim=-1, keepdim=True), min=1e-9)
    return out


def contrastive_loss(params: Encoder, cfg: EncoderConfig, batch,
                     temperature: float = 0.05, *, remat: bool = False):
    """In-batch softmax contrastive loss over (query, passage) pairs, with
    a graph (``encode(..., train=True)``).

    batch: {"q_tokens": (B,S), "q_mask": (B,S), "p_tokens": (B,S), "p_mask": (B,S)}
    (masks optional). Positive of query i is passage i; all other passages
    are in-batch negatives. Returns (loss, {"loss", "in_batch_acc"}), both
    float32 scalars; the accuracy's argmax takes the first of tied scores,
    as ``jnp.argmax``. The caller's backward runs under
    ``device.float32_bf16_sums`` (``train.accum.gradient_accumulation``).
    """
    q = encode(params, cfg, batch["q_tokens"], batch.get("q_mask"),
               train=True, remat=remat)
    p = encode(params, cfg, batch["p_tokens"], batch.get("p_mask"),
               train=True, remat=remat)
    sims = (q @ p.T) / temperature  # (B, B), cosine (encode() normalizes)
    labels = torch.arange(q.shape[0], device=q.device)
    logp = F.log_softmax(sims, dim=-1)
    loss = -logp[labels, labels].mean()
    acc = (sims.argmax(dim=-1) == labels).float().mean()
    return loss, {"loss": loss, "in_batch_acc": acc}
