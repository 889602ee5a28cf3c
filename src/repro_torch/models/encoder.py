"""SBERT-style sentence encoder, the paper's embedding model (port of
``repro.models.encoder``, serving only).

A bidirectional transformer (EncoderConfig.causal=False) with the paper's
three pooling options (CLS / mean / max-over-time), an optional projection
and L2 normalization. The contrastive loss that trains it comes with the
training stack (ROADMAP.md Queue 1, item 7).

    model = init(cfg, torch.Generator().manual_seed(0))   # on the card
    emb = encode(model, cfg, tokens, mask)                 # (B, E) float32
"""
from __future__ import annotations

import torch
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


def init(cfg: EncoderConfig, generator: torch.Generator, device=None) -> Encoder:
    """Parameters drawn from ``generator`` on its device, then moved to
    ``device``: the card unless given ``device="cpu"`` (without a card,
    None raises)."""
    model = Encoder(cfg, generator).to(resolve_device(device))
    return model.requires_grad_(False)


@torch.no_grad()
@float32_bf16_sums()
def encode(params: Encoder, cfg: EncoderConfig, tokens, mask=None, *,
           use_kernel=None):
    """tokens (B, S) -> embeddings (B, E) float32 (L2-normalized if
    cfg.normalize), on the parameters' device. ``use_kernel=False`` runs
    the attention's plain versions on the card as well. bf16 products are
    summed in float32 whatever the caller's cuBLAS setting
    (``device.float32_bf16_sums``)."""
    dev = params.embed.table.device
    tokens = torch.as_tensor(tokens, device=dev)
    if mask is not None:
        mask = torch.as_tensor(mask, dtype=torch.bool, device=dev)
    out = transformer.embed_pooled(params, cfg, tokens, mask,
                                   use_kernel=use_kernel)
    if cfg.project_dim:
        out = out @ params.proj.w.to(out.dtype)
    if cfg.normalize:
        out = out / torch.clamp(torch.linalg.vector_norm(out, dim=-1, keepdim=True),
                                min=1e-9)
    return out
