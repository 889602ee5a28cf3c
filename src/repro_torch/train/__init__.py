"""Training (port of ``repro.train``): AdamW with optional int8 state,
clipping and the cosine schedule (``optim``), micro-batch accumulation
(``accum``) and the error-feedback int8 all-reduce (``compress``); the
step every family trains through (``job``), the encoder's job
(``sbert``) and the recsys retrieval path (``recsys``)."""
from repro_torch.train.optim import (adamw_init, adamw_update, clip_by_global_norm,
                                     cosine_schedule, global_norm)
from repro_torch.train.compress import (dequantize_blockwise, quantize_blockwise,
                                        make_compressed_allreduce)
from repro_torch.train.accum import gradient_accumulation

__all__ = ["adamw_init", "adamw_update", "cosine_schedule", "global_norm",
           "clip_by_global_norm", "quantize_blockwise", "dequantize_blockwise",
           "make_compressed_allreduce", "gradient_accumulation"]
