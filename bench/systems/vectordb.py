"""The ``vectordb`` system: ``repro_torch.VectorDB`` of the configuration's
``engine`` and ``engine_args``, loaded with the collection."""
from __future__ import annotations


def build(cfg: dict, corpus, device):
    """The loaded DB, the entry the window drives."""
    from repro_torch import VectorDB
    db = VectorDB(cfg["engine"], metric=cfg["data"]["metric"], device=device,
                  **cfg["engine_args"])
    db.load(corpus)
    return db


def counters(db) -> dict:
    """The engine's own counters (``adc_stats`` of the IVF-PQ dispatch)."""
    return dict(getattr(db.index, "adc_stats", {}))


def state(db, names) -> dict:
    """The leaves ``names`` of the engine's own snapshot: the trained state
    a reference follows."""
    full = db.index.state_dict()
    return {n: full[n] for n in names}


def describe(db) -> str:
    """A log line of what the window left in the program's counters."""
    from repro_torch.kernels.autotune import LEDGER
    return f"adc_stats {counters(db)} autotuner {LEDGER.decisions()}"
