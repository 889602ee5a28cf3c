"""Engines and the ``VectorDB`` front (port of ``repro.core``): ``flat``
(exact, the recall oracle), ``ivf`` (k-means buckets scored exactly),
``graph`` (a kNN graph and beam search), ``lsh`` (random-hyperplane
signatures, a Hamming shortlist and an exact re-rank), ``int8`` (exact
over an int8 corpus), ``pq`` (the flat PQ ADC scan) and ``ivf_pq`` (IVF
over PQ residual codes); ``flat``, ``ivf``, ``pq`` and ``ivf_pq`` take
writes (``core.mutable``)."""
