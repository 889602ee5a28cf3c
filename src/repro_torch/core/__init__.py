"""Engines and the ``VectorDB`` front (port of ``repro.core``): ``flat``
(exact, the recall oracle), ``ivf`` (k-means buckets scored exactly),
``graph`` (a kNN graph and beam search), ``lsh`` (random-hyperplane
signatures, a Hamming shortlist and an exact re-rank), ``int8`` (exact
over an int8 corpus), ``pq`` (the flat PQ ADC scan) and ``ivf_pq`` (IVF
over PQ residual codes); ``flat``, ``ivf``, ``pq`` and ``ivf_pq`` take
writes (``core.mutable``). The mesh fronts ``DistributedVectorDB``,
``DistributedPQ`` and ``DistributedIVFPQ`` (the last with writes) shard
the exact, PQ and IVF-PQ engines over a ``core.distributed.Mesh``."""
from repro_torch.core.db import (ENGINES, PLAN_BUCKETS, DistributedIVFPQ,
                                 DistributedPQ, DistributedVectorDB, VectorDB,
                                 register_engine)

__all__ = ["ENGINES", "PLAN_BUCKETS", "VectorDB", "DistributedIVFPQ",
           "DistributedPQ", "DistributedVectorDB", "register_engine"]
