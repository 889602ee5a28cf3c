"""Int8 error-feedback gradient all-reduce (port of
``repro.train.compress``).

Quantizing the summand to int8 with one float32 scale a block of 128 cuts
the all-reduce's bytes about 4x; what quantization loses is kept in a
local error-feedback buffer and added back the next step (EF-SGD
[arXiv:1901.09847]), so the long-run mean stays unbiased.

The reference's ``make_compressed_allreduce(axis)`` runs inside
``shard_map``, one program a device. The port keeps
``core.distributed``'s single controller: ``make_compressed_allreduce(mesh,
axis)`` takes one gradient tree and one error tree a shard along ``axis``
(in ``mesh.shard_devices((axis,))`` order, each on its shard's device) and
gives every shard the mean back. What crosses to the merge device is the
wire format, each shard's int8 codes and block scales; they are
dequantized there, summed in shard order, divided by the shard count (the
reference's ``pmean``) and copied back.
"""
from __future__ import annotations

import torch

from repro_torch.train.optim import (BLOCK, _dq8, _pad_flat, _q8, tree_build,
                                     tree_get, tree_map, tree_paths)


def quantize_blockwise(tree):
    """tree of float tensors -> tree of {codes int8, scale f32, n, shape}."""
    def leaf(x):
        flat, n = _pad_flat(x)
        codes, scale = _q8(flat)
        return {"codes": codes, "scale": scale, "n": n, "shape": tuple(x.shape)}
    return tree_map(leaf, tree)


def _is_q(node) -> bool:
    return isinstance(node, dict) and "codes" in node


def _q_paths(qtree, prefix=()):
    if _is_q(qtree):
        return [(prefix, qtree)]
    out = []
    for key in sorted(qtree):
        out.extend(_q_paths(qtree[key], prefix + (key,)))
    return out


def dequantize_blockwise(qtree):
    def leaf(q):
        return _dq8(q["codes"], q["scale"])[: q["n"]].reshape(q["shape"])
    return tree_build((path, leaf(q)) for path, q in _q_paths(qtree))


def compressed_bytes(tree) -> int:
    """Wire bytes for one compressed all-reduce of this tree."""
    total = 0
    for _, leaf in tree_paths(tree):
        n = leaf.numel()
        total += n + -(-n // BLOCK) * 4  # int8 codes + f32 block scales
    return total


def make_compressed_allreduce(mesh, axis_name: str):
    """Error-feedback int8 mean-all-reduce over one axis of ``mesh``:
    ``allreduce(grads, errs) -> (means, new_errs)``, each a list with one
    tree a shard along ``axis_name``. ``means[i]`` is on shard i's device
    in its gradient's dtype; ``new_errs[i]`` is what quantization lost
    there (float32), to pass back in the next step."""
    devices = mesh.shard_devices((axis_name,))
    merge = mesh.merge_device

    def allreduce(grads, errs):
        if len(grads) != len(devices) or len(errs) != len(devices):
            raise ValueError(f"axis {axis_name!r} has {len(devices)} shards, "
                             f"got {len(grads)} gradient and {len(errs)} "
                             "error trees")
        paths = [p for p, _ in tree_paths(grads[0])]
        means = [[] for _ in devices]
        new_errs = [[] for _ in devices]
        for path in paths:
            total = None
            for i, (g_tree, e_tree) in enumerate(zip(grads, errs)):
                g = tree_get(g_tree, path)
                g32 = g.float() + tree_get(e_tree, path)
                flat, n = _pad_flat(g32)
                codes, scale = _q8(flat)
                new_errs[i].append(
                    (path, g32 - _dq8(codes, scale)[:n].reshape(g.shape)))
                # the wire: codes and scales to the merge device
                deq = _dq8(codes.to(merge), scale.to(merge))[:n].reshape(g.shape)
                total = deq if total is None else total + deq
            mean = total / len(devices)
            for i, g_tree in enumerate(grads):
                g = tree_get(g_tree, path)
                means[i].append((path, mean.to(g.device).to(g.dtype)))
        return ([tree_build(m) for m in means],
                [tree_build(e) for e in new_errs])

    return allreduce


def init_error_feedback(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
