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
    (the kernel-against-plain comparisons use it). A DTensor (a sharded
    step's) raises: a kernel runs on each rank's local shard
    (``to_local``), and a sharded tensor never falls back to the plain
    version."""
    if is_dtensor(x):
        raise ValueError("a DTensor reached a kernel wrapper: run the kernel "
                         "on each rank's local shard (to_local)")
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
def bf16_exact_tf32():
    """TF32 products for ``torch.matmul`` on the card inside the block,
    for float32 operands that hold bf16 values: TF32's 10-bit significand
    holds a bf16 value exactly, so the products lose nothing, and the
    tensor cores sum them in float32, in their own order and rounding (not
    IEEE float32's bit for bit): the result lies within the float32
    summation bound of the strict float32 product, at tensor-core rate.
    The caller's setting is restored after."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
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


def is_dtensor(x) -> bool:
    """True for a ``torch.distributed.tensor.DTensor``: a sharded step's
    tensor (``launch.steps``), which a kernel wrapper runs on its local
    shard and never sends down the plain version."""
    if not torch.distributed.is_available():
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)
