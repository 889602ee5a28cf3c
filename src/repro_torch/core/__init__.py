"""Engines and the ``VectorDB`` front (port of ``repro.core``): ``flat``
(exact, the recall oracle), ``pq`` (the flat PQ ADC scan), ``ivf_pq``
(IVF over PQ residual codes) and ``lsh`` (random-hyperplane signatures,
a Hamming shortlist and an exact re-rank); all but ``lsh`` take writes
(``core.mutable``)."""
