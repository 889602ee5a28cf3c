"""Autoregressive decode loop over the transformer's KV cache (port of
``repro.serve.decode``).

Wraps prefill + decode_step into a greedy or temperature sampler; the
cache is grown once to ``max_len`` slots and written in place by each
step. Sliding-window models get a ring buffer of min(max_len, window)
slots, which is what bounds h2o-danube's decode memory and work. A
non-window cache that a prompt plus its continuation outgrow wraps onto
its oldest slots (GQA) or keeps overwriting its last slot (MLA), as in
the reference (``attention.gqa_decode``, ``attention.mla_decode``).

    loop = DecodeLoop(model, cfg, max_len=4096)          # on the card
    tokens = loop.generate(prompt, n_new=64)             # (B, 64) greedy
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import LMConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer


class DecodeLoop:
    """Serves ``params`` (a ``transformer.Transformer``) on ``device``: the
    card unless given ``device="cpu"``, which raises without a card. The
    parameters must lie on that device."""

    def __init__(self, params, cfg: LMConfig, *, max_len: int = 2048,
                 device=None):
        self.device = resolve_device(device)
        have = params.embed.table.device
        if have.type != self.device.type:
            raise ValueError(f"the parameters lie on {have}, the loop serves "
                             f"on {self.device}")
        self.params = params
        self.cfg = cfg
        self.max_len = max_len

    def generate(self, prompt_tokens, *, n_new: int, temperature: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        """prompt_tokens: (B, S) -> (B, n_new) int64 continuation: greedy
        (``argmax``, the first of equal logits, as ``jnp.argmax``) or, with
        ``temperature`` > 0, sampled from softmax(logits / temperature) by
        the Gumbel-max rule with noise from ``generator`` (a generator on
        the loop's device seeded 0 when none is given)."""
        tokens = torch.as_tensor(prompt_tokens, device=self.device)
        B, S = tokens.shape
        logits, cache = transformer.prefill(self.params, self.cfg, tokens)
        # grow the cache to max_len slots (prefill emits S slots; pad the tail)
        target = (self.max_len if self.cfg.window is None
                  else min(self.max_len, self.cfg.window))
        cache = {n: transformer.pad_slots(c, target) for n, c in cache.items()}
        if temperature > 0 and generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        outs = []
        for i in range(n_new):
            lg = logits[:, -1].float()
            if temperature > 0:
                u = torch.rand(lg.shape, generator=generator,
                               device=self.device)
                gumbel = -torch.log(-torch.log(u))
                tok = torch.argmax(lg / temperature + gumbel, dim=-1)[:, None]
            else:
                tok = torch.argmax(lg, dim=-1)[:, None]
            outs.append(tok)
            if i + 1 < n_new:  # the last token's logits are never read
                logits, cache = transformer.decode_step(
                    self.params, self.cfg, tok, cache, S + i)
        return torch.cat(outs, dim=1)
