"""Thistle's vector database on PyTorch and CUDA (the port of ``repro``).

The package mirrors the JAX package's tree: ``core`` holds the engines and
the ``VectorDB`` front (load, query and writes), ``serve`` the two
serving fronts, ``kernels`` the hand-written CUDA kernels (sources in
``csrc``) with their plain PyTorch versions, ``models``, ``configs`` and
``data`` the text encoder the text path serves. It imports ``torch``
and ``numpy`` only; entry points run on the GPU unless given
``device="cpu"``.
"""
from repro_torch.core.db import ENGINES, PLAN_BUCKETS, VectorDB
from repro_torch.device import resolve_device

__all__ = ["ENGINES", "PLAN_BUCKETS", "VectorDB", "resolve_device"]
