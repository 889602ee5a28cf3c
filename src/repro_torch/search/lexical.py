"""BM25 scoring and dense/lexical hybrid fusion (port of
``repro.search.lexical``; host numpy, as in the reference).

``BM25Index`` is an Okapi BM25 inverted index over the token ids of
``data.marco.simple_tokenizer`` (0 = pad, 1 = unk, both ignored), frozen at
build time (``VectorDB.enable_lexical``): scoring is exact, a dense
accumulator over the corpus per query, so it is its own oracle. ``ids``
maps index rows to engine slot ids, so that a predicate's ``allowed``
bitmap composes here too.

``hybrid_merge`` fuses the dense and the lexical candidates of each query:
both score sets min-max normalized to [0, 1], every candidate of the union
scored ``alpha * dense + (1 - alpha) * lexical`` (0 for a side it did not
surface on), duplicates kept on the dense side, one top-k over both sets
(``merge_candidate_sets``, the reference's mesh merge, as a stable sort).

One departure, in speed only: the reference builds the postings in a
Python loop over documents; here one ``np.unique`` over (token, row) pairs
builds the same postings (rows ascending, term frequencies), and each
token's idf is the reference's expression on the same Python numbers.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from repro_torch.data.marco import simple_tokenizer


def _pairs(tokens):
    """(row, token) of every real token (>= 2) of (N, L) ids or a list of
    id lists, rows ascending."""
    if isinstance(tokens, np.ndarray) and tokens.ndim == 2:
        rows, cols = np.nonzero(tokens >= 2)
        return tokens.shape[0], rows.astype(np.int64), \
            tokens[rows, cols].astype(np.int64)
    docs = [np.asarray(row).reshape(-1) for row in tokens]
    docs = [d[d >= 2].astype(np.int64) for d in docs]
    lens = np.asarray([d.shape[0] for d in docs], np.int64)
    rows = np.repeat(np.arange(len(docs), dtype=np.int64), lens)
    toks = np.concatenate(docs) if docs else np.zeros(0, np.int64)
    return len(docs), rows, toks


class BM25Index:
    """Okapi BM25 over token-id documents (0 = pad, 1 = unk, ignored)."""

    def __init__(self, k1: float = 1.5, b: float = 0.75):
        self.k1 = float(k1)
        self.b = float(b)
        self.n_docs = 0
        self.avgdl = 0.0
        self.doc_len = np.zeros((0,), np.float64)
        self.ids = np.zeros((0,), np.int64)  # index row -> engine slot id
        # token -> (doc rows, term frequencies)
        self.postings: Dict[int, tuple] = {}
        self.idf: Dict[int, float] = {}
        self.vocab_size = 0
        self.seq_len = 0

    @classmethod
    def from_tokens(cls, tokens, *, ids=None, k1: float = 1.5,
                    b: float = 0.75) -> "BM25Index":
        """tokens: (N, L) int ids (0/1 = pad/unk) or a list of id lists."""
        idx = cls(k1=k1, b=b)
        N, rows, toks = _pairs(tokens)
        idx.n_docs = N
        idx.doc_len = np.bincount(rows, minlength=N).astype(np.float64)
        idx.avgdl = float(idx.doc_len.mean()) if N else 0.0
        idx.ids = (np.arange(N, dtype=np.int64) if ids is None
                   else np.asarray(ids, np.int64).reshape(-1))
        if idx.ids.shape[0] != N:
            raise ValueError(f"{idx.ids.shape[0]} ids for {N} documents")
        keys, tfs = np.unique(toks * max(N, 1) + rows, return_counts=True)
        tok = keys // max(N, 1)
        row = keys % max(N, 1)
        cuts = np.flatnonzero(np.diff(tok)) + 1
        for start, stop in zip(np.r_[0, cuts], np.r_[cuts, tok.shape[0]]):
            if start == stop:
                continue
            t = int(tok[start])
            idx.postings[t] = (row[start:stop].copy(),
                               tfs[start:stop].astype(np.float64))
            df = int(stop - start)
            idx.idf[t] = float(np.log(1.0 + (N - df + 0.5) / (df + 0.5)))
        return idx

    @classmethod
    def from_texts(cls, texts: Sequence[str], *, vocab_size: int = 30_000,
                   seq_len: int = 64, ids=None, k1: float = 1.5,
                   b: float = 0.75) -> "BM25Index":
        tokens = np.stack([simple_tokenizer(t, vocab_size, seq_len)
                           for t in texts])
        idx = cls.from_tokens(tokens, ids=ids, k1=k1, b=b)
        idx.vocab_size = vocab_size
        idx.seq_len = seq_len
        return idx

    def tokenize(self, texts: Sequence[str]) -> np.ndarray:
        if not self.vocab_size:
            raise ValueError("index was built from raw tokens; pass query "
                             "tokens, not texts")
        return np.stack([simple_tokenizer(t, self.vocab_size, self.seq_len)
                         for t in texts])

    def score(self, q_tokens, *, k: int, allowed=None):
        """BM25 top-k per query. q_tokens: (Q, L) ids or a list of id
        lists; ``allowed``: optional bool bitmap over the engine id space
        (rows outside it never surface).

        Returns (scores (Q, k) f64, ids (Q, k) int64) in engine slot ids;
        rows past the matching documents pad as (-inf, -1).
        """
        Q = len(q_tokens)
        out_s = np.full((Q, k), -np.inf, np.float64)
        out_i = np.full((Q, k), -1, np.int64)
        if self.n_docs == 0 or self.avgdl == 0.0:
            return out_s, out_i
        row_ok = None
        if allowed is not None:
            allowed = np.asarray(allowed, bool).reshape(-1)
            safe = np.clip(self.ids, 0, max(allowed.shape[0] - 1, 0))
            row_ok = (self.ids < allowed.shape[0]) & allowed[safe]
        norm = self.k1 * (1.0 - self.b
                          + self.b * self.doc_len / self.avgdl)  # (N,)
        for qi in range(Q):
            qt = np.asarray(q_tokens[qi])
            qt = np.unique(qt[qt >= 2])
            acc = np.zeros((self.n_docs,), np.float64)
            hit = np.zeros((self.n_docs,), bool)
            for t in qt:
                post = self.postings.get(int(t))
                if post is None:
                    continue
                rows, tfs = post
                acc[rows] += self.idf[int(t)] * tfs * (self.k1 + 1.0) \
                    / (tfs + norm[rows])
                hit[rows] = True
            if row_ok is not None:
                hit &= row_ok
            if not hit.any():
                continue
            cand = np.flatnonzero(hit)
            order = cand[np.argsort(-acc[cand], kind="stable")[:k]]
            out_s[qi, : order.shape[0]] = acc[order]
            out_i[qi, : order.shape[0]] = self.ids[order]
        return out_s, out_i


def _minmax(scores: np.ndarray, ids: np.ndarray) -> np.ndarray:
    """Per-query min-max over the valid entries -> [0, 1]; invalid ->
    -inf. A query whose valid scores are all equal maps them to 1.0."""
    valid = ids >= 0
    s = np.where(valid, scores, np.nan)
    with np.errstate(invalid="ignore"):
        lo = np.nanmin(s, axis=1, keepdims=True)
        hi = np.nanmax(s, axis=1, keepdims=True)
    span = hi - lo
    flat = ~(span > 0)  # degenerate or empty rows
    span = np.where(flat, 1.0, span)
    lo = np.where(flat, np.where(np.isnan(lo), 0.0, lo - 1.0), lo)
    out = (np.where(np.isnan(s), 0.0, s) - lo) / span
    return np.where(valid, out, -np.inf)


def merge_candidate_sets(scores: np.ndarray, ids: np.ndarray, k: int):
    """(S, Q, k') candidate sets -> the global (Q, k): one top-k over the
    sets side by side, equal scores to the lower position (the order
    ``lax.top_k`` gives the reference's merge)."""
    S, Q, kk = scores.shape
    s = np.moveaxis(scores, 0, 1).reshape(Q, S * kk)
    i = np.moveaxis(ids, 0, 1).reshape(Q, S * kk)
    pos = np.argsort(-s, axis=1, kind="stable")[:, :k]
    return (np.take_along_axis(s, pos, axis=1),
            np.take_along_axis(i, pos, axis=1))


def hybrid_merge(dense_s, dense_i, lex_s, lex_i, *, alpha: float, k: int):
    """Fuse dense (ADC) and lexical (BM25) candidate sets (module
    docstring). Returns (scores (Q, k) f32, ids (Q, k) int32), (-inf, -1)
    padded."""
    dense_s = np.asarray(dense_s, np.float64)
    dense_i = np.asarray(dense_i, np.int64)
    lex_s = np.asarray(lex_s, np.float64)
    lex_i = np.asarray(lex_i, np.int64)
    dn = _minmax(dense_s, dense_i)
    ln = _minmax(lex_s, lex_i)
    # lexical score of each dense candidate (0 when it did not surface)
    same = dense_i[:, :, None] == np.where(lex_i < 0, -2, lex_i)[:, None, :]
    lex_for_dense = np.where(same, np.where(np.isneginf(ln), 0.0, ln)[:, None, :],
                             0.0).sum(axis=2)
    fused_dense = np.where(dense_i >= 0,
                           alpha * np.where(np.isneginf(dn), 0.0, dn)
                           + (1.0 - alpha) * lex_for_dense, -np.inf)
    # lexical-only candidates keep (1 - alpha) * lex; duplicates knock out
    dup = same.any(axis=1)
    lex_alive = (lex_i >= 0) & ~dup
    fused_lex = np.where(lex_alive,
                         (1.0 - alpha) * np.where(np.isneginf(ln), 0.0, ln),
                         -np.inf)
    lex_ids = np.where(lex_alive, lex_i, -1)
    kp = max(dense_s.shape[1], lex_s.shape[1])

    def pad(s, i):
        w = kp - s.shape[1]
        if w:
            s = np.pad(s, ((0, 0), (0, w)), constant_values=-np.inf)
            i = np.pad(i, ((0, 0), (0, w)), constant_values=-1)
        return s, i

    ds, di = pad(fused_dense, np.where(dense_i >= 0, dense_i, -1))
    ls, li = pad(fused_lex, lex_ids)
    s, i = merge_candidate_sets(np.stack([ds, ls]).astype(np.float32),
                                np.stack([di, li]).astype(np.int32), k)
    return s, np.where(np.isneginf(s), -1, i).astype(np.int32)

