"""The sharing count of an IVF-ADC visit table on its device, with no host
sync: the CUDA kernel ``csrc/visit_sharing.cu`` and its plain PyTorch
version. It replaces no TPU kernel: the reference counts on the host
(``core.ivf.visit_sharing``, a mask and a ``unique``, two syncs), which
``kernels.ops.ivf_adc_topk`` still does wherever the count decides a grid.

``visit_sharing_device`` dispatches on the table's device: a CUDA tensor
launches the kernel (one memset and one launch), a CPU tensor runs the
plain version (a presence bitmap scattered from the ids, then summed).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.device import kernel_path
from repro_torch.kernels import _build

HEAD = 4  # int64 slots ahead of the bits (csrc/visit_sharing.cu kHead)
LAUNCHES = _build.LaunchCounter("visit_sharing")

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "visit_sharing_launch": ([_P, ctypes.c_longlong, _I, _I, _P, _P], _I),
}


def visit_sharing_plain(visit, n_blocks: int, *, pad_block=None) -> dict:
    """``core.ivf.visit_sharing``'s numbers as 0-dim device tensors
    (``pairs`` and ``blocks`` int64, ``sharing`` float64). ``blocks`` comes
    from a presence bitmap over the ``n_blocks`` block ids (every id of
    ``visit`` is below it) less ``pad_block``'s bit. Nothing here copies a
    host value into a device tensor, which would sync."""
    v = torch.as_tensor(visit).reshape(-1).long()
    present = torch.zeros(n_blocks, dtype=torch.bool, device=v.device)
    present.scatter_(0, v, True)
    blocks = present.sum()
    if pad_block is None:
        pairs = torch.full((), v.numel(), dtype=torch.int64, device=v.device)
    else:
        pairs = (v != pad_block).sum()
        blocks = blocks - present[pad_block].long()
    return {"pairs": pairs, "blocks": blocks,
            "sharing": pairs.double() / blocks.clamp(min=1).double()}


def visit_sharing_cuda(visit, n_blocks: int, *, pad_block=None) -> dict:
    """The kernel: the same three numbers, views of one int64 workspace
    that the launch zeroes and fills."""
    v = visit.reshape(-1).to(torch.int32).contiguous()
    if pad_block is not None and not 0 <= int(pad_block) < n_blocks:
        raise ValueError(f"pad_block {pad_block} is not a block id in "
                         f"0..{n_blocks - 1}")
    ws = torch.empty(HEAD + (n_blocks + 63) // 64, dtype=torch.int64,
                     device=v.device)
    lib = _build.load("visit_sharing", _SIGNATURES)
    code = lib.visit_sharing_launch(
        v.data_ptr(), v.numel(), n_blocks,
        -1 if pad_block is None else int(pad_block), ws.data_ptr(),
        torch.cuda.current_stream(v.device).cuda_stream)
    _build.check(lib, code, "visit_sharing")
    LAUNCHES.n += 1
    return {"pairs": ws[0], "blocks": ws[1],
            "sharing": ws[2:3].view(torch.float64)[0]}


def visit_sharing_device(visit, n_blocks: int, *, pad_block=None,
                         use_kernel=None) -> dict:
    """``{pairs, blocks, sharing}`` of a (Q, T) visit table whose block ids
    lie in 0..n_blocks-1, counted on its device with no host sync: 0-dim
    int64, int64 and float64 tensors, equal to ``core.ivf.visit_sharing``'s
    numbers once read."""
    if kernel_path(visit, use_kernel):
        return visit_sharing_cuda(visit, n_blocks, pad_block=pad_block)
    return visit_sharing_plain(visit, n_blocks, pad_block=pad_block)
