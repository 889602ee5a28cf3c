"""Synthetic data (port of ``repro.data``): ``marco``, the procedural
MS-MARCO-like passages and queries of the text path and the encoder's
training; ``lm``, Zipfian token streams and the sharded host loader."""
from repro_torch.data.lm import TokenStream, host_shard_iterator
from repro_torch.data.marco import MarcoLike, simple_tokenizer

__all__ = ["MarcoLike", "TokenStream", "host_shard_iterator",
           "simple_tokenizer"]
