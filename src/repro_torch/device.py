"""Where the port runs: the GPU unless the caller asks for the CPU.

Entry points take ``device=None`` and resolve it here. There is no silent
fallback: without a card, ``None`` raises, and a caller that wants the
plain PyTorch versions on the CPU (the tests) passes ``device="cpu"``.
"""
from __future__ import annotations

import contextlib

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card, and raises when there is none."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: repro_torch serves on the GPU; pass "
                "device='cpu' to run the plain PyTorch versions")
        return torch.device("cuda")
    return torch.device(device)


def kernel_path(x: torch.Tensor, use_kernel=None) -> bool:
    """True when a kernel wrapper should launch its CUDA kernel for ``x``.

    The rule follows the tensor: a CUDA tensor launches the kernel, a CPU
    tensor runs the plain version. ``use_kernel=True`` on a CPU tensor
    raises; ``use_kernel=False`` runs the plain version on either device
    (the kernel-against-plain comparisons use it)."""
    if use_kernel is None:
        return x.is_cuda
    if use_kernel and not x.is_cuda:
        raise ValueError(
            f"use_kernel=True needs a CUDA tensor, got one on {x.device}")
    return bool(use_kernel)


@contextlib.contextmanager
def strict_fp32():
    """Full float32 for ``torch.matmul`` on the card inside the block (no
    TF32, which keeps about three decimal digits); the caller's setting is
    restored after. Also usable as a decorator."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


@contextlib.contextmanager
def float32_bf16_sums():
    """bf16 products on the card summed in float32 inside the block, as
    XLA sums them for the reference: cuBLAS's reduced-precision bf16
    reductions (PyTorch's default) are off, and the caller's setting is
    restored after, also when the block raises. Also usable as a
    decorator."""
    mm = torch.backends.cuda.matmul
    prev = mm.allow_bf16_reduced_precision_reduction
    mm.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        mm.allow_bf16_reduced_precision_reduction = prev
