"""Engines and the ``VectorDB`` front (port of ``repro.core``): ``flat``
(exact, the recall oracle), ``pq`` (the flat PQ ADC scan) and ``ivf_pq``
(IVF over PQ residual codes)."""
