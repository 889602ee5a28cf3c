"""Synthetic click logs for the recsys archs (Criteo-like + sequences).

Labels come from a hidden latent-factor model: each (field, id) has a latent
vector, the click logit is a low-rank pairwise interaction plus noise. A
learner with the right inductive bias (FM!) can therefore beat AUC 0.5 by a
wide margin, so training curves are meaningful, while id frequencies follow
the power law that makes the embedding lookup the system bottleneck.
Port of ``repro.data.clicks``: host numpy, the same arrays from a seed.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.configs.base import RecsysConfig
from repro_torch.models.recsys import field_offsets


@dataclasses.dataclass
class ClickLogs:
    cfg: RecsysConfig
    latent_dim: int = 8
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self.sizes = np.asarray(self.cfg.field_vocab_sizes(), np.int64)
        self.offsets = field_offsets(self.cfg)
        # hidden latents live in a small hashed space so memory stays bounded
        self._hash_space = 65_536
        self._latent = rng.normal(size=(self._hash_space, self.latent_dim)).astype(np.float32)
        self._w = rng.normal(size=(self._hash_space,)).astype(np.float32) * 0.1
        self._rng = rng

    def _sample_field_ids(self, rng, batch: int) -> np.ndarray:
        """Power-law ids per field -> (B, F) field-local."""
        F = self.cfg.n_sparse
        out = np.zeros((batch, F), np.int64)
        for f in range(F):
            n = self.sizes[f]
            # discrete power law via inverse-CDF on u^alpha
            u = rng.random(batch)
            out[:, f] = np.minimum((n * u ** 2.2).astype(np.int64), n - 1)
        return out

    def batch(self, batch: int, step: int = 0) -> dict:
        rng = np.random.default_rng((self.seed, step))
        ids = self._sample_field_ids(rng, batch)  # field-local
        uni = ids + self.offsets[None, : self.cfg.n_sparse]
        h = (uni * 2654435761 % self._hash_space).astype(np.int64)
        lat = self._latent[h]  # (B, F, k)
        s = lat.sum(axis=1)
        logit = 0.5 * ((s * s).sum(-1) - (lat * lat).sum(-1).sum(-1))
        logit = logit * 0.1 + self._w[h].sum(-1)
        dense = rng.normal(size=(batch, self.cfg.n_dense)).astype(np.float32)
        logit = logit + 0.3 * dense.sum(-1)
        p = 1.0 / (1.0 + np.exp(-(logit - np.median(logit))))
        label = (rng.random(batch) < p).astype(np.float32)
        return {"sparse_idx": uni.astype(np.int32), "dense": dense, "label": label}

    def sequence_batch(self, batch: int, step: int = 0) -> dict:
        """SASRec batches: user sequences from latent-neighborhood walks."""
        cfg = self.cfg
        rng = np.random.default_rng((self.seed, step, 7))
        S, n_items = cfg.seq_len, cfg.n_items
        seq = np.zeros((batch, S), np.int64)
        length = rng.integers(S // 2, S + 1, size=batch)
        # items cluster: item i's neighbors are i +/- small deltas
        cur = rng.integers(1, n_items + 1, size=batch)
        for s in range(S):
            active = s < length
            delta = rng.integers(-20, 21, size=batch)
            cur = np.clip(cur + delta, 1, n_items)
            seq[:, s] = np.where(active, cur, 0)
        # next-item targets: shift left; pad tail
        pos = np.zeros_like(seq)
        pos[:, :-1] = seq[:, 1:]
        neg = rng.integers(1, n_items + 1, size=seq.shape)
        neg = np.where(pos == 0, 0, neg)
        return {"seq": seq.astype(np.int32), "pos": pos.astype(np.int32),
                "neg": neg.astype(np.int32)}
