"""Procedural MS-MARCO-like retrieval corpus (port of ``repro.data.marco``,
numpy only, the same draws from the same seed).

The real dataset is Bing queries + passages; what the paper's benchmark needs
from it is (a) a passage corpus, (b) queries that paraphrase exactly one
passage, (c) exact ground truth. We generate that: passages are sampled from
a Zipfian vocabulary with per-passage topic bias (so passages are mutually
distinguishable), queries subsample a passage's salient tokens and corrupt
them with a controlled noise rate (word drop / replacement — the "as soon as
more than a few words changed" failure the paper saw with LSH becomes a
measurable dial).

Text is emitted as both token-id arrays (for our encoders) and whitespace
strings (for the load_texts path).
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import List, Tuple

import numpy as np


def simple_tokenizer(text: str, vocab_size: int, seq_len: int) -> np.ndarray:
    """Deterministic hash tokenizer: whitespace split -> stable ids (0 = pad).

    crc32, not Python hash(): str hash is salted per process
    (PYTHONHASHSEED), which made lexical/hybrid scores drift across runs.
    """
    ids = [zlib.crc32(w.encode()) % (vocab_size - 2) + 2 for w in text.split()]
    ids = ids[:seq_len]
    return np.asarray(ids + [0] * (seq_len - len(ids)), np.int32)


@dataclasses.dataclass
class MarcoLike:
    """Generator over (passage corpus, query per passage) with exact truth."""

    n_passages: int = 1000
    vocab_size: int = 30_000
    passage_len: int = 48
    query_len: int = 12
    noise: float = 0.15  # fraction of query tokens replaced by random words
    n_topics: int = 64
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        V, P, L = self.vocab_size, self.n_passages, self.passage_len
        # global Zipf over the vocabulary
        ranks = np.arange(2, V)  # 0 pad, 1 unk
        zipf = 1.0 / ranks.astype(np.float64)
        zipf /= zipf.sum()
        # per-topic token bias: each topic boosts a random 1% slice of vocab
        topic_of = rng.integers(0, self.n_topics, size=P)
        self.passages = np.zeros((P, L), np.int32)
        self.salient = np.zeros((P, L), bool)
        boost = max(1, (V - 2) // 100)
        for t in range(self.n_topics):
            rows = np.where(topic_of == t)[0]
            if rows.size == 0:
                continue
            t_rng = np.random.default_rng(self.seed * 1000 + 17 + t)
            topic_ids = t_rng.choice(ranks, size=boost, replace=False)
            p = zipf.copy()
            p[topic_ids - 2] *= 50.0
            p /= p.sum()
            toks = t_rng.choice(ranks, size=(rows.size, L), p=p)
            self.passages[rows] = toks
            # salient = topic-boosted tokens (the ones a query would reuse)
            self.salient[rows] = np.isin(toks, topic_ids)
        self.topic_of = topic_of
        self._rng = rng
        self._ranks = ranks
        self._zipf = zipf

    def queries(self, noise: float | None = None, n: int | None = None) -> np.ndarray:
        """One query per passage: subsample its tokens, inject noise. ``n``
        keeps the first n rows, the same as the full call's (rows draw in
        order), without drawing the rest."""
        noise = self.noise if noise is None else noise
        P, Lq = self.n_passages if n is None else min(n, self.n_passages), self.query_len
        rng = np.random.default_rng(self.seed + 1)
        out = np.zeros((P, Lq), np.int32)
        for i in range(P):
            # prefer salient tokens, fall back to any
            sal = self.passages[i][self.salient[i]]
            pool = sal if sal.size >= Lq else self.passages[i]
            take = rng.choice(pool, size=Lq, replace=pool.size < Lq)
            flip = rng.random(Lq) < noise
            noise_toks = rng.choice(self._ranks, size=Lq, p=self._zipf)
            out[i] = np.where(flip, noise_toks, take)
        return out

    # ------------------------------------------------------------ text views
    @staticmethod
    def _to_text(tok_rows: np.ndarray) -> List[str]:
        return [" ".join(f"w{t}" for t in row if t >= 2) for row in tok_rows]

    def passage_texts(self) -> List[str]:
        return self._to_text(self.passages)

    def query_texts(self, noise: float | None = None, n: int | None = None) -> List[str]:
        return self._to_text(self.queries(noise, n))

    def contrastive_batches(self, batch: int, n_batches: int, seq_len: int = 0):
        """(q_tokens, p_tokens) pair batches for siamese SBERT training."""
        L = seq_len or self.passage_len
        rng = np.random.default_rng(self.seed + 2)
        qs = self.queries()
        for _ in range(n_batches):
            idx = rng.integers(0, self.n_passages, size=batch)
            q = np.zeros((batch, L), np.int32)
            q[:, : self.query_len] = qs[idx]
            p = self.passages[idx][:, :L]
            yield {"q_tokens": q, "q_mask": q != 0, "p_tokens": p, "p_mask": p != 0}
