"""Transformer stack for serving (port of ``repro.models.transformer``, the
dense-block forward and the pooled embedding the vector-DB tower reads).

    init(cfg, generator, device=None)           -> Transformer
    forward(params, cfg, tokens, kv_mask=None)  -> hidden (B, S, D)
    embed_pooled(params, cfg, tokens, mask)     -> (B, D) float32

The reference scans a stack of layer parameters; here ``dense_blocks`` is
a ``ModuleList`` walked in order. MoE blocks, the MTP head, the LM head and
its loss, prefill and decode come with ROADMAP.md Queue 1, item 8.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import LMConfig
from repro_torch.device import float32_bf16_sums, resolve_device
from repro_torch.models import attention as attn_lib
from repro_torch.models.layers import MLP, Embed, Norm, apply_embed, apply_mlp, apply_norm

# ================================================================ init


class Block(nn.Module):
    """One dense pre-norm block: ``attn_norm``, ``attn``, ``mlp_norm``, ``mlp``."""

    def __init__(self, generator, cfg: LMConfig, dtype=torch.float32):
        super().__init__()
        dev = generator.device
        self.attn_norm = Norm(cfg.norm, cfg.d_model, dtype, dev)
        self.attn = attn_lib.init_attention(generator, cfg, dtype)
        self.mlp_norm = Norm(cfg.norm, cfg.d_model, dtype, dev)
        self.mlp = MLP(generator, cfg.d_model, cfg.dense_ff, cfg.gated_mlp, dtype)


class Transformer(nn.Module):
    """``embed``, ``dense_blocks`` (one ``Block`` a layer), ``final_norm``:
    the reference's parameter tree under the same names, with the stacked
    layer axis unrolled into the module list."""

    def __init__(self, cfg: LMConfig, generator: torch.Generator):
        super().__init__()
        if cfg.moe is not None:
            raise NotImplementedError(
                "MoE blocks come with the LM stack (ROADMAP.md Queue 1, item "
                "8); the port serves dense encoders so far")
        if cfg.mtp_depth:
            raise NotImplementedError(
                "the MTP head is training-only and comes with the LM stack "
                "(ROADMAP.md Queue 1, item 8)")
        dtype = getattr(torch, cfg.param_dtype)
        self.embed = Embed(generator, cfg.vocab_size, cfg.d_model, dtype)
        self.dense_blocks = nn.ModuleList(
            Block(generator, cfg, dtype) for _ in range(cfg.n_dense_layers))
        self.final_norm = Norm(cfg.norm, cfg.d_model, dtype, generator.device)


def init(cfg: LMConfig, generator: torch.Generator, device=None) -> Transformer:
    """Parameters drawn from ``generator`` on its device, then moved to
    ``device`` (the card unless given ``device="cpu"``). Serving only: no
    parameter asks for a gradient."""
    model = Transformer(cfg, generator).to(resolve_device(device))
    return model.requires_grad_(False)


# ================================================================ forward


def _block_fwd(cfg: LMConfig, p: Block, x, positions, kv_mask, *,
               use_kernel=None):
    h = attn_lib.gqa_attention(p.attn, cfg, apply_norm(p.attn_norm, x),
                               positions, kv_mask=kv_mask, use_kernel=use_kernel)
    if cfg.parallel_residual:
        y_in = apply_norm(p.mlp_norm, x)
    else:
        x = x + h
        y_in = apply_norm(p.mlp_norm, x)
    y = apply_mlp(p.mlp, y_in, cfg.act)
    return x + y + h if cfg.parallel_residual else x + y


@torch.no_grad()
@float32_bf16_sums()
def forward(params: Transformer, cfg: LMConfig, tokens, *, kv_mask=None,
            use_kernel=None):
    """tokens: (B, S) int -> hidden (B, S, D) in cfg.dtype; bf16 products
    summed in float32, as XLA sums them (``device.float32_bf16_sums``)."""
    dtype = getattr(torch, cfg.dtype)
    S = tokens.shape[1]
    x = apply_embed(params.embed, tokens, dtype)
    positions = torch.arange(S, device=x.device)
    for block in params.dense_blocks:
        x = _block_fwd(cfg, block, x, positions, kv_mask, use_kernel=use_kernel)
    return x


# ================================================================ vector-DB tower


@torch.no_grad()
def embed_pooled(params: Transformer, cfg: LMConfig, tokens, mask=None, *,
                 use_kernel=None):
    """Pool hidden states into one vector per sequence (the DB's encoder API).

    mask: (B, S) bool validity; pooling per cfg.pool ("mean" default for LMs).
    """
    h = forward(params, cfg, tokens, kv_mask=mask, use_kernel=use_kernel)
    h = apply_norm(params.final_norm, h).float()
    if mask is None:
        mask = torch.ones(tokens.shape, dtype=torch.bool, device=h.device)
    m = mask[..., None].float()
    pool = cfg.pool if cfg.pool != "none" else "mean"
    if pool == "cls":
        return h[:, 0]
    if pool == "max":
        return torch.where(m > 0, h, -torch.inf).amax(dim=1)
    return (h * m).sum(dim=1) / torch.clamp(m.sum(dim=1), min=1e-6)
