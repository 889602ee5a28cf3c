"""The synthetic collection and the query pools, made on the device from the
run's seed.

Copied from ``chip_smoke.py`` (``cluster_frame``, ``clustered_rows`` and
``make_dataset``, lines 438-485 at the commit this benchmark was written
on) and frozen here, so that no later change to that script moves the
yardstick. Rows are unit vectors around floor(sqrt N) random unit centres
that share an 8-dimensional subspace; the held-out rows after the corpus
are the intents queries are drawn from.

Every call draws from one ``torch.Generator`` on the device in a fixed
order, so the same seed gives the same corpus, and ``regenerate`` gives the
reference the very rows the program was handed.
"""
from __future__ import annotations

import math

import torch

CHUNK = 1 << 18   # rows a generator chunk (the chunking fixes the draws)


def cluster_frame(d: int, gen, device, *, n_centres: int, rank: int):
    """(centres, basis): ``n_centres`` random unit centres and a
    ``rank``-dimensional subspace they share, the first draws of ``gen``."""
    centres = torch.randn(n_centres, d, generator=gen, device=device)
    centres /= torch.linalg.vector_norm(centres, dim=1, keepdim=True)
    basis = torch.randn(rank, d, generator=gen, device=device) / math.sqrt(d)
    return centres, basis


def clustered_rows(n: int, d: int, gen, device, *, n_centres: int, rank: int,
                   spread: float, noise: float):
    """Unit rows around ``n_centres`` random unit centres: each row is its
    centre plus a draw from the shared ``rank``-dimensional subspace (scale
    ``spread``) plus isotropic noise, normalized; a chunk at a time."""
    centres, basis = cluster_frame(d, gen, device, n_centres=n_centres,
                                   rank=rank)
    out = torch.empty((n, d), dtype=torch.float32, device=device)
    for a in range(0, n, CHUNK):
        b = min(n, a + CHUNK)
        which = torch.randint(centres.shape[0], (b - a,), generator=gen,
                              device=device)
        z = torch.randn(b - a, rank, generator=gen, device=device) * spread
        x = centres[which] + z @ basis
        x += noise * torch.randn(b - a, d, generator=gen, device=device)
        out[a:b] = x / torch.linalg.vector_norm(x, dim=1, keepdim=True)
    return out


def normalize(x):
    return x / torch.linalg.vector_norm(x, dim=1, keepdim=True)


def collection(data: dict, n_held: int, seed: int, device):
    """(generator, corpus (N, d), held (n_held, d)) of a configuration's
    ``data`` block: the corpus is a view of one buffer of N + n_held rows,
    and the generator goes on to draw the queries."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    n = int(data["rows"])
    rows = clustered_rows(n + n_held, int(data["dim"]), gen, device,
                          n_centres=max(1, math.isqrt(n)),
                          rank=int(data["rank"]), spread=float(data["spread"]),
                          noise=float(data["noise"]))
    return gen, rows[:n], rows[n:].clone()


def query_pool(traffic: dict, held, gen):
    """The traffic's pool of queries on the device: with ``intents`` 0 each
    held-out row is its own intent, in order; otherwise each query picks
    one of the first ``intents`` held-out rows, rank r drawn with weight
    r^-``zipf``. Each query is its intent plus ``query_noise`` a
    dimension, normalized."""
    pool = int(traffic["pool"])
    n_int = int(traffic.get("intents", 0))
    if n_int:
        w = torch.arange(1, n_int + 1, dtype=torch.float64,
                         device=held.device) ** -float(traffic["zipf"])
        which = torch.multinomial(w, pool, replacement=True, generator=gen)
        base = held[:n_int][which]
    else:
        which = torch.arange(pool, device=held.device)
        base = held[:pool]
    q = base + float(traffic["query_noise"]) * torch.randn(
        base.shape, generator=gen, device=held.device)
    return normalize(q), which


def held_rows(traffic: dict) -> int:
    """Held-out rows a traffic draws its intents from."""
    return max(int(traffic["pool"]), int(traffic.get("intents", 0)))


def fingerprint(corpus) -> torch.Tensor:
    """Float64 sums of 64 spread rows: set-up records it, and the reference
    checks that its regenerated corpus gives the same."""
    n = corpus.shape[0]
    idx = torch.linspace(0, n - 1, 64, device=corpus.device).long()
    return corpus[idx].double().sum(dim=1).cpu()


def regenerate(data: dict, traffic: dict, seed: int, device):
    """The corpus again, as ``collection`` made it for this traffic."""
    _, corpus, _ = collection(data, held_rows(traffic), seed, device)
    return corpus
