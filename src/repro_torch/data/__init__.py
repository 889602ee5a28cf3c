"""Synthetic data (port of ``repro.data``): ``marco``, the procedural
MS-MARCO-like passages and queries of the text path."""
from repro_torch.data.marco import MarcoLike, simple_tokenizer

__all__ = ["MarcoLike", "simple_tokenizer"]
