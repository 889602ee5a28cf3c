"""Int8 corpus with asymmetric scoring (port of ``repro.core.quant``).

Each row is quantized symmetrically with one float32 scale:

    c_q = round(c / scale_row),  scale_row = max|c_row| / 127   (int8)
    q.c ~= (q . c_q) * scale_row

so the corpus takes a quarter of its float32 bytes; queries stay float32.
For l2 the exact |c|^2 (float32) is kept, so only the cross term is
quantized, as in the reference.

The scan runs the ``topk_distance`` kernel: the codes are dequantized one
chunk of rows at a time into one float32 scratch buffer (``codes *
scales`` in a single pass, at most ``SCAN_BYTES``), each chunk goes through
``kops.topk_distance`` with the predicate bitmap as its knockout, and the
chunks' top k are merged with a stable sort (ties to the lower id). No
(Q, N) score matrix is built. A score is ``q . (c_q * scale)`` where the
reference computes ``(q . c_q) * scale``: the same value in another
rounding order.

Like the reference's engine this one takes no writes.
"""
from __future__ import annotations

import torch

from repro_torch.core import distances as D
from repro_torch.core.flat import _check_snapshot
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops

SCAN_BYTES = 1 << 30  # float32 scratch a chunk of dequantized rows may take
LOAD_CHUNK = 1 << 18  # rows a chunk when the corpus is quantized at load


def quantize_rows(x):
    """x: (N, d) float32 -> (codes int8 (N, d), scales float32 (N,))."""
    absmax = torch.amax(torch.abs(x), dim=-1)
    scale = torch.clamp(absmax, min=1e-12) / 127.0
    codes = torch.clamp(torch.round(x / scale[:, None]), -127, 127)
    return codes.to(torch.int8), scale


def dequantize_rows(codes, scales, out=None):
    """codes (n, d) int8, scales (n,) -> (n, d) float32 ``codes * scale``,
    one elementwise pass (into ``out`` when given)."""
    return torch.mul(codes, scales[:, None], out=out)


def scan_rows(d: int) -> int:
    """Rows a chunk of the scan takes so its float32 rows fit SCAN_BYTES."""
    return max(1, SCAN_BYTES // (4 * d))


def int8_search(codes, scales, q, *, metric: str, k: int, corpus_sq=None,
                valid=None, use_kernel=None):
    """Exact top-k over an int8 corpus; q stays float32. ``valid`` ((N,)
    bool: the predicate bitmap) knocks rows out. Returns (scores (Q, k),
    ids (Q, k) int32), knocked-out slots as (-inf, -1). ``use_kernel``
    goes to ``kops.topk_distance`` (False: the plain version)."""
    N, d = codes.shape
    k = min(k, N)
    q = q.float()
    if metric == "cosine":
        q = D.l2_normalize(q)  # rows were normalized before quantization
        metric = "dot"
    chunk = min(N, scan_rows(d))
    # rows dequantized into the first d columns of a zeroed scratch as wide
    # as the kernel takes (``distances.pad_width``); q padded to match
    q = D.pad_width(q)
    scratch = torch.zeros((chunk, q.shape[1]), dtype=torch.float32,
                          device=q.device)
    best = None
    for a in range(0, N, chunk):
        b = min(N, a + chunk)
        dequantize_rows(codes[a:b], scales[a:b], out=scratch[:b - a, :d])
        s, i = kops.topk_distance(
            scratch[:b - a], q, k=min(k, b - a), metric=metric,
            corpus_sq=None if corpus_sq is None else corpus_sq[a:b],
            valid=None if valid is None else valid[a:b],
            use_kernel=use_kernel)
        i = i + a
        best = (s, i) if best is None else D.merge_topk(*best, s, i, k)
    return kops.normalize_knockouts(*best)


class Int8FlatIndex:
    """Exact engine over an int8 corpus (a quarter of the float32 bytes).
    Codes, scales and |c|^2 for l2 live on ``device``."""

    def __init__(self, metric: str = "cosine", device=None):
        if metric not in D.METRICS:
            raise ValueError(f"metric {metric!r} not in {D.METRICS}")
        self.metric = metric
        self.device = resolve_device(device)
        self.codes = self.scales = self.corpus_sq = None

    @property
    def size(self) -> int:
        return 0 if self.codes is None else int(self.codes.shape[0])

    def load(self, vectors):
        """Normalize (cosine) or take |c|^2 (l2) and quantize, a chunk of
        rows at a time: no float32 copy of the corpus is made."""
        x = torch.as_tensor(vectors, dtype=torch.float32, device=self.device)
        N, d = x.shape
        self.codes = torch.empty((N, d), dtype=torch.int8, device=self.device)
        self.scales = torch.empty(N, dtype=torch.float32, device=self.device)
        self.corpus_sq = (torch.empty(N, dtype=torch.float32,
                                      device=self.device)
                          if self.metric == "l2" else None)
        for a in range(0, N, LOAD_CHUNK):
            rows, sq = D.preprocess_corpus(x[a:a + LOAD_CHUNK], self.metric)
            self.codes[a:a + LOAD_CHUNK], self.scales[a:a + LOAD_CHUNK] = \
                quantize_rows(rows)
            if sq is not None:
                self.corpus_sq[a:a + LOAD_CHUNK] = sq
        return self

    def query(self, q, k: int = 10, *, allowed=None, use_kernel=None):
        q = torch.atleast_2d(torch.as_tensor(q, dtype=torch.float32,
                                             device=self.device))
        valid = kops.and_allowed(None, allowed, self.codes.shape[0])
        return int8_search(self.codes, self.scales, q, metric=self.metric,
                           k=k, corpus_sq=self.corpus_sq, valid=valid,
                           use_kernel=use_kernel)

    def load_state(self, state) -> "Int8FlatIndex":
        """Codes (int8), scales and, for l2, corpus_sq, as the reference's
        engine holds them (it has no ``state_dict``: a caller builds the
        dict from its attributes and passes it through
        ``core.convert.from_reference_state``)."""
        _check_snapshot(state, "int8", self.metric)
        dev = self.device
        codes = torch.as_tensor(state["codes"], device=dev)
        if codes.dtype != torch.int8:
            raise ValueError(f"codes must be int8, got {codes.dtype}")
        self.codes = codes
        self.scales = torch.as_tensor(state["scales"], dtype=torch.float32,
                                      device=dev)
        sq = state.get("corpus_sq")
        self.corpus_sq = (None if sq is None else
                          torch.as_tensor(sq, dtype=torch.float32, device=dev))
        return self

    def memory_bytes(self) -> int:
        """Codes, scales and |c|^2: the engine's device bytes."""
        total = self.codes.numel() + self.scales.numel() * 4
        if self.corpus_sq is not None:
            total += self.corpus_sq.numel() * 4
        return int(total)
