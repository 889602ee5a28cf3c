"""Synthetic data (port of ``repro.data``): ``marco``, the procedural
MS-MARCO-like passages and queries of the text path and the encoder's
training; ``lm``, Zipfian token streams and the sharded host loader;
``clicks``, the recsys click logs and sequences; ``graphs``, the SBM
graph and packed molecule batches."""
from repro_torch.data.clicks import ClickLogs
from repro_torch.data.graphs import molecule_batch, sbm_graph
from repro_torch.data.lm import TokenStream, host_shard_iterator
from repro_torch.data.marco import MarcoLike, simple_tokenizer

__all__ = ["ClickLogs", "MarcoLike", "TokenStream", "host_shard_iterator",
           "molecule_batch", "sbm_graph", "simple_tokenizer"]
