"""LSH engine: random-hyperplane signatures + Hamming-distance shortlist
(port of ``repro.core.lsh``).

sign(x . P) gives each row an n_bits signature per table, packed 32 bits a
word (bit j of word w is plane 32 w + j, least significant first) and
carried as int32 bit patterns. A query ranks every row by the min over T
tables of the Hamming distance between signatures
(``kernels.ops.hamming_shortlist``: the CUDA ``hamming`` kernel on the
card, which keeps only the ``shortlist`` nearest rows as it scores), and
the shortlist is re-ranked exactly. Colliding in any table promotes a
candidate: the paper's multi-table semantics.

Random-hyperplane LSH is a cosine family (collision probability 1 -
angle / pi); for l2 and dot the signatures still hash directions and the
re-rank uses the true metric. ``jax.random`` planes cannot be drawn from a
seed in torch, so the reference's planes cross through
``core.convert.from_reference_state`` and the port draws its own from a
``torch.Generator``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import distances as D
from repro_torch.core.flat import _check_snapshot
from repro_torch.device import resolve_device, strict_fp32
from repro_torch.kernels import ops as kops

PROJ_BUDGET = 1 << 26  # projections a chunk of sign_codes makes (256 MB f32)


def make_planes(gen: torch.Generator, d: int, n_bits: int, n_tables: int):
    """(n_tables, d, n_bits) standard normal hyperplanes on gen's device."""
    return torch.randn((n_tables, d, n_bits), generator=gen,
                       device=gen.device, dtype=torch.float32)


def _pack_bits(bits):
    """(T, n, b) bool -> (T, n, ceil(b / 32)) int32 bit patterns."""
    T, n, b = bits.shape
    pad = (-b) % 32
    words = F.pad(bits.to(torch.int64), (0, pad)).reshape(T, n, -1, 32)
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    packed = torch.sum(words << shifts, dim=-1)                 # [0, 2^32)
    return torch.where(packed >= 2 ** 31, packed - 2 ** 32, packed).to(
        torch.int32)


@strict_fp32()
def sign_codes(x, planes):
    """x: (N, d); planes: (T, d, b) -> packed codes (T, N, ceil(b/32))
    int32, a chunk of rows at a time so the (T, rows, b) projection stays
    under PROJ_BUDGET floats. Full float32 (no TF32): a projection within
    rounding of 0 takes the sign of its rounding."""
    T, _, b = planes.shape
    N = x.shape[0]
    out = torch.empty((T, N, -(-b // 32)), dtype=torch.int32, device=x.device)
    chunk = max(1, PROJ_BUDGET // (T * b))
    for a in range(0, N, chunk):
        proj = torch.einsum("nd,tdb->tnb", x[a:a + chunk].float(), planes)
        out[:, a:a + proj.shape[1]] = _pack_bits(proj >= 0)
    return out


def hamming_distance(q_codes, c_codes):
    """q: (T, Q, W); c: (T, N, W) int32 -> min-over-tables distance (Q, N),
    the plain oracle of the ranking pass."""
    return kops.hamming(q_codes, c_codes, use_kernel=False)


@strict_fp32()
def rerank(corpus, cand, q, *, metric: str, k: int, corpus_sq=None):
    """Exact scores of the (Q, L) candidate rows ``cand``, best k first;
    metric in {dot, l2} (cosine = dot on normalized rows). With fewer than
    k candidates the tail is (-inf, -1)."""
    rows = cand.long()
    vecs = corpus[rows].float()                                    # (Q, L, d)
    qf = q.float()
    dots = torch.einsum("qd,qld->ql", qf, vecs)
    if metric == "dot":
        scores = dots
    else:
        sq = (corpus_sq[rows] if corpus_sq is not None
              else torch.sum(torch.square(vecs), -1))
        scores = -(torch.sum(torch.square(qf), -1)[:, None] - 2.0 * dots + sq)
    kk = min(k, cand.shape[1])
    s, pos = D.topk_scores(scores, kk)
    ids = torch.gather(cand, 1, pos)
    if kk < k:
        s = F.pad(s, (0, k - kk), value=-torch.inf)
        ids = F.pad(ids, (0, k - kk), value=-1)
    return s, ids


def lsh_search(corpus, c_codes, planes, q, *, metric: str, k: int,
               shortlist: int, corpus_sq=None, use_kernel=None):
    """Hamming shortlist, then exact re-rank. Returns (scores (Q, k) f32,
    ids (Q, k) int32); with fewer than k candidates the tail is (-inf, -1).
    ``use_kernel=False`` runs the shortlist's plain version on the card
    (the kernel-against-plain comparison)."""
    if metric == "cosine":
        q = D.l2_normalize(q)
        metric = "dot"
    q_codes = sign_codes(q, planes)
    _, cand = kops.hamming_shortlist(q_codes, c_codes,
                                     min(shortlist, corpus.shape[0]),
                                     use_kernel=use_kernel)
    return rerank(corpus, cand, q, metric=metric, k=k, corpus_sq=corpus_sq)


class LSHIndex:
    """Random-hyperplane LSH (the paper's third ANN engine). Corpus, |c|^2
    for l2, planes and codes live on ``device``."""

    def __init__(self, metric: str = "cosine", n_bits: int = 128,
                 n_tables: int = 4, shortlist: int = 64, seed: int = 0,
                 dtype=torch.float32, device=None):
        if metric not in D.METRICS:
            raise ValueError(f"metric {metric!r} not in {D.METRICS}")
        self.metric = metric
        self.n_bits = n_bits
        self.n_tables = n_tables
        self.shortlist = shortlist
        self.seed = seed
        self.dtype = dtype
        self.device = resolve_device(device)
        self.corpus = self.codes = self.planes = self.corpus_sq = None

    @property
    def size(self) -> int:
        return 0 if self.corpus is None else int(self.corpus.shape[0])

    def load(self, vectors):
        x = torch.as_tensor(vectors, dtype=torch.float32, device=self.device)
        corpus, self.corpus_sq = D.preprocess_corpus(x, self.metric)
        del x
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        self.planes = make_planes(gen, corpus.shape[1], self.n_bits,
                                  self.n_tables)
        self.codes = sign_codes(corpus, self.planes)
        self.corpus = corpus.to(self.dtype)
        return self

    def query(self, q, k: int = 10):
        q = torch.atleast_2d(torch.as_tensor(q, dtype=torch.float32,
                                             device=self.device))
        return lsh_search(self.corpus, self.codes, self.planes,
                          q.to(self.dtype), metric=self.metric, k=k,
                          shortlist=self.shortlist, corpus_sq=self.corpus_sq)

    # ------------------------------------------------------- persistence
    def state_dict(self) -> dict:
        state = {"engine": "lsh", "metric": self.metric,
                 "shortlist": self.shortlist, "seed": self.seed,
                 "planes": self.planes, "codes": self.codes,
                 "corpus": self.corpus}
        if self.corpus_sq is not None:
            state["corpus_sq"] = self.corpus_sq
        return state

    def load_state(self, state) -> "LSHIndex":
        """Load a state (``state_dict``, or ``core.convert.from_reference_state``
        of the reference's planes, codes, corpus and corpus_sq; codes as
        int32 bit patterns). n_bits and n_tables follow the planes."""
        _check_snapshot(state, "lsh", self.metric)
        dev = self.device
        self.planes = torch.as_tensor(state["planes"], dtype=torch.float32,
                                      device=dev)
        codes = torch.as_tensor(state["codes"], device=dev)
        if codes.dtype != torch.int32:
            raise ValueError(f"codes must be int32 bit patterns, got {codes.dtype}")
        self.codes = codes
        self.corpus = torch.as_tensor(state["corpus"], device=dev).to(self.dtype)
        sq = state.get("corpus_sq")
        self.corpus_sq = (None if sq is None else
                          torch.as_tensor(sq, dtype=torch.float32, device=dev))
        self.n_tables, _, self.n_bits = self.planes.shape
        self.shortlist = int(state.get("shortlist", self.shortlist))
        self.seed = int(state.get("seed", self.seed))
        return self

    def memory_bytes(self, include_raw: bool = False) -> int:
        """Index-resident bytes: codes and planes (and |c|^2 for l2, and the
        re-rank corpus with ``include_raw``)."""
        total = self.codes.numel() * 4 + self.planes.numel() * 4
        if self.corpus_sq is not None:
            total += self.corpus_sq.numel() * 4
        if include_raw:
            total += self.corpus.numel() * self.corpus.element_size()
        return int(total)
