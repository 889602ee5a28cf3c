"""Hand-written CUDA kernels for Hopper with their plain PyTorch versions
(port of ``repro.kernels``). Sources live in ``repro_torch/csrc`` and are
built at first use (``kernels._build``)."""
