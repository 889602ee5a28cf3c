"""Engines and the ``VectorDB`` front (port of ``repro.core``): ``flat``
(exact, the recall oracle) and ``ivf_pq`` (IVF over PQ residual codes)."""
