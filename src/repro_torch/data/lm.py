"""LM token streams and the sharded host loader (port of
``repro.data.lm``; numpy only, the same draws from the same seed).

TokenStream yields (tokens, labels) batches from a Zipfian unigram stream
with short-range bigram structure (so perplexity falls during training).
host_shard_iterator is the multi-host data path: each host owns its
1/n_hosts slice of every global batch, and ``skip_steps`` supports the
straggler path (a late host's shard is dropped and the loss rescales over
the survivors).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Set

import numpy as np


@dataclasses.dataclass
class TokenStream:
    vocab_size: int = 32_000
    seed: int = 0
    # bigram structure: each token strongly predicts a few successors
    branch: int = 4

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        V = self.vocab_size
        ranks = np.arange(1, V)
        zipf = 1.0 / ranks.astype(np.float64) ** 1.1
        self._zipf = zipf / zipf.sum()
        self._ranks = ranks
        # successor table: token t -> `branch` preferred next tokens
        self._succ = rng.integers(1, V, size=(V, self.branch))

    def batch(self, batch: int, seq_len: int, step: int) -> dict:
        """Deterministic batch for a global step (replayable on restart)."""
        rng = np.random.default_rng((self.seed, step))
        B, S = batch, seq_len
        toks = np.zeros((B, S + 1), np.int64)
        toks[:, 0] = rng.choice(self._ranks, size=B, p=self._zipf)
        for s in range(1, S + 1):
            follow = rng.random(B) < 0.75
            pick = self._succ[toks[:, s - 1], rng.integers(0, self.branch, B)]
            fresh = rng.choice(self._ranks, size=B, p=self._zipf)
            toks[:, s] = np.where(follow, pick, fresh)
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}


def host_shard_iterator(stream: TokenStream, *, global_batch: int, seq_len: int,
                        host_id: int, n_hosts: int, start_step: int = 0,
                        skip_steps: Optional[Set[int]] = None) -> Iterator[dict]:
    """Each host materializes only its 1/n_hosts slice of every global
    batch, a function of (step, host_id), so a restarted host resumes
    mid-stream with no coordination; on a step in ``skip_steps`` it yields
    a zero-weight batch (labels all -100, ``skipped`` True)."""
    if global_batch % n_hosts:
        raise ValueError(f"global batch {global_batch} does not split over "
                         f"{n_hosts} hosts")
    local = global_batch // n_hosts
    step = start_step
    while True:
        full = stream.batch(global_batch, seq_len, step)
        sl = slice(host_id * local, (host_id + 1) * local)
        out = {k: v[sl] for k, v in full.items()}
        if skip_steps and step in skip_steps:
            out = {k: np.zeros_like(v) for k, v in out.items()}
            out["labels"] = np.full_like(out["labels"], -100)  # ignore-all
            out["skipped"] = True
        yield out
        step += 1
