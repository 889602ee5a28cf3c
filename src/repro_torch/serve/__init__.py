"""Serving fronts over ``VectorDB`` (port of ``repro.serve``): the
synchronous pump ``QueryEngine`` and the continuous-batching
``AsyncQueryEngine``."""
from repro_torch.serve.async_engine import AsyncQueryEngine, BackpressureError
from repro_torch.serve.engine import QueryEngine, Request, WriteRequest

__all__ = ["QueryEngine", "AsyncQueryEngine", "BackpressureError",
           "Request", "WriteRequest"]
