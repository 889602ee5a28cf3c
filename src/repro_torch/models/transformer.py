"""Transformer stack (port of ``repro.models.transformer``): the dense and
MoE block stacks, the LM head's logits, the training loss with the MoE's
aux losses and the MTP head, serving (prefill and KV-cache decode) and the
pooled embedding the vector-DB tower reads.

    init(cfg, generator, device=None, trainable=False)  -> Transformer
    forward(params, cfg, tokens, kv_mask=None)          -> (hidden (B, S, D), aux)
    forward(..., train=True, remat=False)               -> the same, with a graph
    logits_from_hidden(params, cfg, h)                  -> (..., vocab)
    loss_fn(params, cfg, batch, remat=False)            -> (loss, metrics)
    init_cache(cfg, batch, max_len, device=None)        -> cache
    prefill(params, cfg, tokens)                        -> (last logits, cache)
    decode_step(params, cfg, token, cache, pos)         -> (logits, cache)
    embed_pooled(params, cfg, tokens, mask)             -> (B, D) float32

The reference scans stacks of layer parameters; here ``dense_blocks``,
``moe_blocks`` and ``mtp`` are ``ModuleList``s walked in order
(``core.convert`` stacks and unstacks the layer axis). The cache keeps
the reference's stacked layout, one array a kind over all layers:
``{"k", "v"}`` of (L, B, C, KV, dh) for GQA, ``{"ckv", "krope"}`` of (L,
B, C, kv_lora) and (L, B, C, qk_rope) for MLA; a sliding window's cache
is a ring of C = window slots. Prefill and decode run the blocks in the
sequential pre-norm form whatever ``parallel_residual`` says, as the
reference's serving path does (no LM config sets it); ``forward`` honours
it. Serving never reads the MTP head; ``loss_fn`` adds its loss.
"""
from __future__ import annotations

import contextlib

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import LMConfig
from repro_torch.device import float32_bf16_sums, is_dtensor, resolve_device
from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models.layers import (MLP, Embed, Norm, apply_embed, apply_mlp,
                                       apply_norm, dense_init)

# Activation-sharding hook (the reference's ``ACT_SHARDING``), set by
# ``launch.steps.moe_constraints`` for the duration of a sharded step:
# (mesh, batch axes). DTensor activations are then anchored at each block's
# input to (batch-sharded, replicated, replicated), and the logits shard
# their vocab dim over "model": without it the loss would hold a replicated
# float32 logits tensor on every rank.
ACT_SHARDING = None


# Per-layer parameter hook, set by ``launch.steps.bound`` for a sharded
# step in the training layout: a context manager over one block in which
# its parameters are whole over the FSDP axes (ZeRO-3: a layer's weights are
# gathered where it runs, and again in a remat backward, never all at once).
LAYER_GATHER = None


def _layer(p):
    return LAYER_GATHER(p) if LAYER_GATHER is not None else contextlib.nullcontext()


def _act_constrain(x):
    if ACT_SHARDING is None or not is_dtensor(x):
        return x
    from repro_torch.core.distributed import P, with_sharding_constraint
    mesh, dp = ACT_SHARDING
    return with_sharding_constraint(x, mesh, P(dp, *([None] * (x.ndim - 1))))


def _grad_anchor(x):
    """A DTensor activation of a sharded step whose gradient is laid out
    as it is (``core.distributed.grad_anchor``): at the inputs of the
    column-parallel matmuls (the normed block input, the LM head's)."""
    if ACT_SHARDING is None or not is_dtensor(x):
        return x
    from repro_torch.core.distributed import grad_anchor
    return grad_anchor(x)


def _logits_constrain(x):
    if ACT_SHARDING is None or not is_dtensor(x):
        return x
    from repro_torch.core.distributed import P, with_sharding_constraint
    mesh, dp = ACT_SHARDING
    return with_sharding_constraint(
        x, mesh, P(dp, *([None] * (x.ndim - 2)), "model"))


# ================================================================ init


class Block(nn.Module):
    """One pre-norm block: ``attn_norm``, ``attn``, ``mlp_norm`` and either
    ``mlp`` (dense, d_ff ``dense_ff``) or ``moe``."""

    def __init__(self, generator, cfg: LMConfig, dtype=torch.float32, *,
                 is_moe: bool = False):
        super().__init__()
        dev = generator.device
        self.attn_norm = Norm(cfg.norm, cfg.d_model, dtype, dev)
        self.attn = attn_lib.init_attention(generator, cfg, dtype)
        self.mlp_norm = Norm(cfg.norm, cfg.d_model, dtype, dev)
        if is_moe:
            self.moe = moe_lib.MoE(generator, cfg, dtype)
            self.mlp = None
        else:
            self.mlp = MLP(generator, cfg.d_model, cfg.dense_ff, cfg.gated_mlp,
                           dtype)
            self.moe = None


class Head(nn.Module):
    """``w`` (d_model, vocab): the LM head the reference builds where
    embeddings are untied (the encoder never reads it)."""

    def __init__(self, generator, d: int, vocab: int, dtype=torch.float32):
        super().__init__()
        self.w = dense_init(generator, d, vocab, dtype)


class MTP(nn.Module):
    """One multi-token-prediction module (deepseek-v3): ``proj`` (2 d, d),
    ``norm_h``, ``norm_e`` and a dense ``block``. ``loss_fn`` reads the
    first; serving never reads it."""

    def __init__(self, generator, cfg: LMConfig, dtype=torch.float32):
        super().__init__()
        dev = generator.device
        self.proj = dense_init(generator, 2 * cfg.d_model, cfg.d_model, dtype)
        self.norm_h = Norm(cfg.norm, cfg.d_model, dtype, dev)
        self.norm_e = Norm(cfg.norm, cfg.d_model, dtype, dev)
        self.block = Block(generator, cfg, dtype)


class Transformer(nn.Module):
    """``embed``, ``dense_blocks``, ``moe_blocks`` (one ``Block`` a layer),
    ``final_norm``, ``lm_head`` unless ``tie_embeddings``, and ``mtp``
    with ``mtp_depth``: the reference's parameter tree under the same
    names, with each stacked layer axis unrolled into a module list. Each
    leaf is drawn on the generator's device in ``param_dtype``, one at a
    time (a float32 draw of that leaf, then the cast)."""

    def __init__(self, cfg: LMConfig, generator: torch.Generator):
        super().__init__()
        dtype = getattr(torch, cfg.param_dtype)
        self.embed = Embed(generator, cfg.vocab_size, cfg.d_model, dtype)
        self.dense_blocks = nn.ModuleList(
            Block(generator, cfg, dtype) for _ in range(cfg.n_dense_layers))
        self.moe_blocks = nn.ModuleList(
            Block(generator, cfg, dtype, is_moe=True)
            for _ in range(cfg.n_moe_layers))
        self.final_norm = Norm(cfg.norm, cfg.d_model, dtype, generator.device)
        self.lm_head = (None if cfg.tie_embeddings else
                        Head(generator, cfg.d_model, cfg.vocab_size, dtype))
        self.mtp = (nn.ModuleList(MTP(generator, cfg, dtype)
                                  for _ in range(cfg.mtp_depth))
                    if cfg.mtp_depth else None)

    def layers(self):
        """The blocks in the order the stack runs: dense, then MoE."""
        return list(self.dense_blocks) + list(self.moe_blocks)


def init(cfg: LMConfig, generator: torch.Generator, device=None, *,
         trainable: bool = False) -> Transformer:
    """Parameters drawn from ``generator`` on its device (a CUDA generator
    builds them on the card), then moved to ``device`` (the card unless
    given ``device="cpu"``; without a card, None raises before anything is
    drawn). Frozen for serving unless ``trainable``."""
    dev = resolve_device(device)
    model = Transformer(cfg, generator).to(dev)
    return model.requires_grad_(trainable)


# ================================================================ forward


def _zero_aux(device) -> dict:
    return {name: torch.zeros((), device=device)
            for name in ("load_balance", "router_z", "dropped_frac")}


def _router_score(cfg: LMConfig) -> str:
    return "sigmoid" if (cfg.moe and cfg.moe.n_routed >= 256) else "softmax"


def _attention(cfg: LMConfig):
    return attn_lib.mla_attention if cfg.mla else attn_lib.gqa_attention


def _ffn(cfg: LMConfig, p: Block, y_in, capacity_factor=None):
    """The block's MLP or MoE on its normed input: (y, aux), aux the MoE's
    (zeros for a dense block)."""
    if p.moe is not None:
        return moe_lib.apply_moe(p.moe, cfg, y_in,
                                 capacity_factor=capacity_factor,
                                 router_score=_router_score(cfg))
    return apply_mlp(p.mlp, y_in, cfg.act), _zero_aux(y_in.device)


def _block_fwd(cfg: LMConfig, p: Block, x, positions, kv_mask, *,
               capacity_factor=None, use_kernel=None, train: bool = False):
    """One block: (x, aux), aux the MoE's (zeros for a dense block)."""
    x = _act_constrain(x)
    with _layer(p):
        h = _act_constrain(_attention(cfg)(
            p.attn, cfg, _grad_anchor(apply_norm(p.attn_norm, x)), positions,
            kv_mask=kv_mask, use_kernel=use_kernel, train=train))
        if cfg.parallel_residual:
            y_in = apply_norm(p.mlp_norm, x)
        else:
            x = x + h
            y_in = apply_norm(p.mlp_norm, x)
        y, aux = _ffn(cfg, p, _grad_anchor(y_in), capacity_factor)
        y = _act_constrain(y)
    return (x + y + h if cfg.parallel_residual else x + y), aux


@float32_bf16_sums()
def forward(params: Transformer, cfg: LMConfig, tokens, *, kv_mask=None,
            use_kernel=None, train: bool = False, remat: bool = False,
            capacity_factor=None):
    """tokens: (B, S) int -> (hidden (B, S, D) in cfg.dtype, aux): aux sums
    the MoE blocks' ``load_balance`` and ``router_z`` and averages their
    ``dropped_frac`` (float32 scalars). bf16 products are summed in
    float32, as XLA sums them (``device.float32_bf16_sums``).

    Serving (``train=False``) runs under ``torch.no_grad()`` with the
    attention kernel on a CUDA tensor. ``train=True`` builds the graph
    through ``attention.dense_or_chunked_attention`` on every device (the
    reference differentiates that rule; the kernel is forward only), and
    ``remat=True`` checkpoints each block (``use_reentrant=False``), as the
    reference's ``jax.checkpoint(body, nothing_saveable)``: only block
    inputs are kept, the rest is recomputed in the backward pass. The
    caller's backward must run under ``float32_bf16_sums`` as well
    (``train.accum.gradient_accumulation`` does)."""
    dtype = getattr(torch, cfg.dtype)
    S = tokens.shape[1]
    with contextlib.nullcontext() if train else torch.no_grad():
        x = _act_constrain(apply_embed(params.embed, tokens, dtype))
        positions = torch.arange(S, device=x.device)
        aux = _zero_aux(x.device)
        for block in params.layers():
            if train and remat:
                x, a = checkpoint(_block_fwd, cfg, block, x, positions,
                                  kv_mask, capacity_factor=capacity_factor,
                                  train=True, use_reentrant=False)
            else:
                x, a = _block_fwd(cfg, block, x, positions, kv_mask,
                                  capacity_factor=capacity_factor,
                                  use_kernel=use_kernel, train=train)
            aux = {name: aux[name] + a[name] for name in aux}
        aux["dropped_frac"] = aux["dropped_frac"] / max(cfg.n_moe_layers, 1)
    return x, aux


@float32_bf16_sums()
def logits_from_hidden(params: Transformer, cfg: LMConfig, h):
    """final_norm, then the LM head (the embedding's transpose when tied),
    in h's dtype."""
    h = _grad_anchor(apply_norm(params.final_norm, h))
    w = (params.embed.table.T if cfg.tie_embeddings else params.lm_head.w)
    return _logits_constrain(h @ w.to(h.dtype))


# ================================================================ training


def _masked_ce(logits, labels):
    """Mean of -log p[label] over the positions whose label is >= 0 (-100
    ignores one), the denominator max(count, 1): a batch with no valid
    label gives 0. logsumexp minus the label's logit. Logits that are a
    DTensor (a sharded step) take ``_vocab_parallel_nll``: each rank
    reduces its own vocab shard, as the reference's ``_sharded_ce``
    reduces its model-sharded vocab axis locally and then psums."""
    valid = labels >= 0
    safe = torch.where(valid, labels, 0).long()
    if is_dtensor(logits):
        nll = _vocab_parallel_nll(logits, safe)
    else:
        picked = torch.gather(logits, -1, safe[..., None])[..., 0]
        nll = torch.logsumexp(logits, dim=-1) - picked
    denom = torch.clamp(valid.sum(), min=1)
    return torch.where(valid, nll, 0.0).sum() / denom


def _picked(x, labels, offset: int):
    """(x[..., label - offset] where the label falls in this shard's
    columns, else 0; the column index clamped into the shard)."""
    loc = labels - offset
    inside = (loc >= 0) & (loc < x.shape[-1])
    loc = torch.clamp(loc, 0, x.shape[-1] - 1)
    return torch.where(inside, torch.gather(x, -1, loc[..., None])[..., 0],
                       0.0), loc, inside


class _VocabParallelNLL(torch.autograd.Function):
    """-log softmax(x)[label] over a vocab split across ranks, on each
    rank's shard x (..., V / n) float32 of columns [offset, offset + V / n):
    the local max all-reduced (max), the local sum of exp(x - max)
    all-reduced (sum), the label's logit where this shard holds it
    all-reduced (sum); nll = log(sum) + max - picked. ``dims`` are the
    mesh dims the vocab splits over (none: ``logsumexp`` and the pick's
    arithmetic, bit for bit). The backward is the local
    softmax minus the local one-hot, times the incoming gradient: no rank
    ever holds more than its own shard."""

    @staticmethod
    def forward(ctx, x, labels, offset, mesh, dims):
        from repro_torch.core.distributed import all_reduce_over
        m = all_reduce_over(x.amax(dim=-1), "max", mesh, dims)
        total = all_reduce_over(torch.exp(x - m[..., None]).sum(dim=-1),
                                "sum", mesh, dims)
        picked = all_reduce_over(_picked(x, labels, offset)[0], "sum", mesh,
                                 dims)
        lse = torch.log(total) + m
        ctx.save_for_backward(x, labels, lse)
        ctx.offset = offset
        return lse - picked

    @staticmethod
    def backward(ctx, grad):
        x, labels, lse = ctx.saved_tensors
        _, loc, inside = _picked(x, labels, ctx.offset)
        # grad * softmax, then -grad at the label: the order (and so the
        # rounding) of logsumexp's backward plus the pick's
        p = (x - lse[..., None]).exp_().mul_(grad[..., None])
        p.scatter_add_(-1, loc[..., None],
                       torch.where(inside, -grad, 0.0)[..., None])
        return p, None, None, None, None


def _vocab_parallel_nll(logits, labels):
    """nll (..., ) of DTensor ``logits`` (..., V) against global label ids
    (a DTensor or a plain tensor that every rank holds), each rank on its
    own vocab shard (``_VocabParallelNLL``). Batch rows stay split where
    the logits split them (dim 0); any other split of the logits is made
    whole first. The result is split like the logits' rows and whole over
    the vocab's mesh dims."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.core.distributed import contiguous_stride, replicated
    mesh = logits.device_mesh
    last = logits.ndim - 1
    pl = [p if isinstance(p, Shard) and p.dim in (0, last) else Replicate()
          for p in logits.placements]
    logits = logits.redistribute(mesh, pl)
    out_pl = [Replicate() if p == Shard(last) else p for p in pl]
    labels = replicated(labels, mesh).redistribute(mesh, out_pl)
    dims = [i for i, p in enumerate(pl) if p == Shard(last)]
    # this rank's first column: the dim chunked over its mesh dims left to
    # right (``torch.chunk``'s ceil-sized pieces)
    offset, size = 0, logits.shape[last]
    for i in dims:
        chunk = -(-size // mesh.size(i))
        start = min(mesh.get_local_rank(i) * chunk, size)
        offset, size = offset + start, min(chunk, size - start)
    nll = _VocabParallelNLL.apply(logits.to_local(), labels.to_local(),
                                  offset, mesh, dims)
    shape = logits.shape[:-1]
    return DTensor.from_local(nll, mesh, out_pl, run_check=False, shape=shape,
                              stride=contiguous_stride(shape))


@float32_bf16_sums()
def loss_fn(params: Transformer, cfg: LMConfig, batch, *, remat: bool = False):
    """batch: {"tokens": (B, S), "labels": (B, S) with -100 = ignore} ->
    (loss, metrics), with a graph (``forward(train=True)``). The loss is
    the cross entropy over float32 logits plus the MoE's ``load_balance``
    and ``router_z``, and with ``mtp_depth`` the depth-1 MTP head's cross
    entropy times ``mtp_loss_weight``: an extra dense block reads
    [norm_h(h_t) ; norm_e(embed(tok_{t+1}))] @ proj at positions 0..S-2
    and predicts ``labels[:, 1:]`` through the shared head. metrics:
    ``ce``, ``dropped_frac``, ``loss`` and, with the head, ``mtp_ce``.
    ``remat`` checkpoints each block of the stack (not the MTP block, as
    in the reference)."""
    tokens, labels = batch["tokens"], batch["labels"]
    h, aux = forward(params, cfg, tokens, train=True, remat=remat)
    ce = _masked_ce(logits_from_hidden(params, cfg, h).float(), labels)
    metrics = {"ce": ce, "dropped_frac": aux["dropped_frac"]}
    loss = ce + aux["load_balance"] + aux["router_z"]
    if cfg.mtp_depth and params.mtp is not None:
        mtp = params.mtp[0]  # depth 1
        dtype = getattr(torch, cfg.dtype)
        S = tokens.shape[1]
        emb_next = apply_embed(params.embed, tokens[:, 1:], dtype)
        h_in = torch.cat([apply_norm(mtp.norm_h, h[:, :-1]),
                          apply_norm(mtp.norm_e, emb_next)], dim=-1)
        h_in = h_in @ mtp.proj.to(dtype)
        h_mtp, _ = _block_fwd(cfg, mtp.block, h_in,
                              torch.arange(S - 1, device=h.device), None,
                              train=True)
        mtp_ce = _masked_ce(logits_from_hidden(params, cfg, h_mtp).float(),
                            labels[:, 1:])
        loss = loss + cfg.mtp_loss_weight * mtp_ce
        metrics["mtp_ce"] = mtp_ce
    metrics["loss"] = loss
    return loss, metrics


# ================================================================ serving


def init_cache(cfg: LMConfig, batch: int, max_len: int, dtype=None,
               device=None) -> dict:
    """An empty decode cache (zeros) in the reference's layout: a sliding
    window's is a ring of min(max_len, window) slots, else max_len."""
    dtype = dtype or cfg.dtype
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    dev = resolve_device(device)
    C = min(max_len, cfg.window) if cfg.window else max_len
    L = cfg.n_layers
    if cfg.mla:
        shapes = {"ckv": (L, batch, C, cfg.mla.kv_lora_rank),
                  "krope": (L, batch, C, cfg.mla.qk_rope_dim)}
    else:
        shapes = {name: (L, batch, C, cfg.n_kv_heads, cfg.head_dim)
                  for name in ("k", "v")}
    return {name: torch.zeros(shape, dtype=dtype, device=dev)
            for name, shape in shapes.items()}


def _cache_names(cfg: LMConfig):
    return ("ckv", "krope") if cfg.mla else ("k", "v")


@torch.no_grad()
@float32_bf16_sums()
def prefill(params: Transformer, cfg: LMConfig, tokens, *, use_kernel=None):
    """Full forward emitting the KV cache; returns (last-token logits
    (B, 1, vocab), cache). The cache holds every position, (L, B, S, ...);
    with a sliding window W only the last W positions are kept, in the ring
    layout: for S > W rolled by S % W so that position i sits at slot
    i % W, for S <= W padded with zeros to W slots. MoE blocks route at the
    config's capacity factor, as ``forward`` does."""
    dtype = getattr(torch, cfg.dtype)
    B, S = tokens.shape
    x = _act_constrain(apply_embed(params.embed, tokens, dtype))
    positions = torch.arange(S, device=x.device)
    names = _cache_names(cfg)
    cache = None
    for i, p in enumerate(params.layers()):
        x = _act_constrain(x)
        with _layer(p):
            h, kv = _attention(cfg)(p.attn, cfg, apply_norm(p.attn_norm, x),
                                    positions, return_kv=True,
                                    use_kernel=use_kernel)
            if cache is None:
                cache = {n: _new_layers(t, cfg.n_layers)
                         for n, t in zip(names, kv)}
            for n, t in zip(names, kv):
                cache[n][i] = t
            x = x + _act_constrain(h)
            x = x + _act_constrain(_ffn(cfg, p, apply_norm(p.mlp_norm, x))[0])
    if cfg.window:
        W = cfg.window
        if S > W:
            # positions S-W..S-1 live at slots (S-W..S-1) % W: a roll puts them right
            cache = {n: roll_slots(c[:, :, -W:], S % W)
                     for n, c in cache.items()}
        else:
            cache = {n: pad_slots(c, W) for n, c in cache.items()}
    return logits_from_hidden(params, cfg, x[:, -1:]), cache


def _new_layers(t, L: int):
    """An uninitialized (L, *t.shape) tensor laid out as t: a DTensor's
    split stays on its dims (one over) with each rank's shard allocated
    locally; the whole stack would otherwise sit on every rank."""
    if not is_dtensor(t):
        return t.new_empty((L,) + tuple(t.shape))
    from torch.distributed.tensor import DTensor, Shard

    from repro_torch.core.distributed import contiguous_stride
    local = t.to_local()
    pl = [Shard(p.dim + 1) if isinstance(p, Shard) else p
          for p in t.placements]
    shape = (L,) + tuple(t.shape)
    return DTensor.from_local(local.new_empty((L,) + tuple(local.shape)),
                              t.device_mesh, pl, run_check=False,
                              shape=shape, stride=contiguous_stride(shape))


def roll_slots(c, r: int):
    """``torch.roll(c, r, dims=2)`` as two slices of the slot axis joined:
    on a DTensor cache (split over batch or heads, never slots) slicing and
    ``cat`` keep the split, where some PyTorch releases have no sharding
    rule for ``roll``."""
    if r == 0:
        return c
    return torch.cat([c[:, :, -r:], c[:, :, :-r]], dim=2)


def pad_slots(c, n: int):
    """Zero slots appended on the cache's slot axis (2) up to n."""
    pad = n - c.shape[2]
    if pad <= 0:
        return c
    return torch.cat([c, c.new_zeros(c.shape[:2] + (pad,) + c.shape[3:])],
                     dim=2)


@torch.no_grad()
@float32_bf16_sums()
def decode_step(params: Transformer, cfg: LMConfig, token, cache: dict, pos):
    """token: (B, 1) int; pos: the token's position (the next one after
    the cache's). Returns (logits (B, 1, vocab), cache), the cache written
    in place: GQA at slot pos % C (a ring for a window, a wrap otherwise),
    MLA at pos clamped to C - 1 (``attention.mla_decode``). The first
    ``n_dense_layers`` cache layers go with the dense blocks, the rest with
    the MoE blocks, which route at the config's capacity factor (C >= 4
    slots, so a batch of up to 4 tokens is never dropped)."""
    dtype = getattr(torch, cfg.dtype)
    pos = int(pos)
    x = _act_constrain(apply_embed(params.embed, token, dtype))
    a, b = _cache_names(cfg)
    decode = attn_lib.mla_decode if cfg.mla else attn_lib.gqa_decode
    for i, p in enumerate(params.layers()):
        h, _ = decode(p.attn, cfg, apply_norm(p.attn_norm, x), cache[a][i],
                      cache[b][i], pos)
        x = x + _act_constrain(h)
        x = x + _act_constrain(_ffn(cfg, p, apply_norm(p.mlp_norm, x))[0])
    return logits_from_hidden(params, cfg, x), cache


# ================================================================ vector-DB tower


def embed_pooled(params: Transformer, cfg: LMConfig, tokens, mask=None, *,
                 use_kernel=None, train: bool = False, remat: bool = False):
    """Pool hidden states into one vector per sequence (the DB's encoder API).

    mask: (B, S) bool validity; pooling per cfg.pool ("mean" default for LMs).
    Without a graph unless ``train`` (see ``forward``).
    """
    with contextlib.nullcontext() if train else torch.no_grad():
        h, _ = forward(params, cfg, tokens, kv_mask=mask, use_kernel=use_kernel,
                       train=train, remat=remat)
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
