"""Filtered and hybrid search (port of ``repro.search``): predicate
bitmaps over the engines' knockouts (``search.meta``) and BM25 fused with
the dense scores (``search.lexical``). Entry point:
``VectorDB.query(where=..., hybrid=...)``."""
from repro_torch.search.lexical import BM25Index, hybrid_merge
from repro_torch.search.meta import (And, Eq, In, MetadataStore, Not, Or,
                                     Predicate, Range, filter_hash)

__all__ = ["And", "Eq", "In", "MetadataStore", "Not", "Or", "Predicate",
           "Range", "filter_hash", "BM25Index", "hybrid_merge"]
