"""AdamW with optional int8-blockwise moment state (port of
``repro.train.optim``: functions over trees of tensors).

A tree is nested dicts and lists of tensors (None entries are empty
subtrees), as a JAX pytree is; its leaves are taken in the reference's
order, dict keys sorted, list items by index. The formula
and its order of operations are the reference's:

    m = b1 m + (1 - b1) g;  v = b2 v + (1 - b2) g^2
    upd = (m / c1) / (sqrt(v / c2) + eps),  c1 = 1 - b1^t, c2 = 1 - b2^t
    p <- p - lr (upd + wd p)

with t the step after this update and c1, c2, the schedule and lr in
float32. fp32 Adam state is 8 bytes a parameter; the int8 path stores both
moments as int8 codes with one float32 scale a block of 128 (about 2.06
bytes a parameter), v in the sqrt domain, the blockwise scheme of
bitsandbytes [arXiv:2110.02861]. A leaf whose last dim is a multiple of
128 keeps its shape (blocks along the last dim); any other leaf is
flattened and zero-padded to a multiple of 128. ``torch.optim.AdamW``
rounds in another order and has no int8 state, so it is not this
function.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import is_dtensor

BLOCK = 128


# ---------------------------------------------------------------- trees


def tree_paths(tree, prefix=()) -> list:
    """[(path, leaf)] in the reference's flatten order (keys sorted, list
    items by index, None skipped). ``path`` is a tuple of keys, a list
    item's key its int index."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        items = sorted(tree.items())
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return [(prefix, tree)]
    out = []
    for key, sub in items:
        out.extend(tree_paths(sub, prefix + (key,)))
    return out


def tree_get(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def tree_build(pairs) -> dict:
    """The inverse of ``tree_paths``: [(path, value)] -> nested dicts, a
    node whose keys are ints a list in index order."""
    out = {}
    for path, value in pairs:
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = value
    return _listify(out)


def _listify(node):
    if not isinstance(node, dict):
        return node
    out = {k: _listify(v) for k, v in node.items()}
    if out and all(isinstance(k, int) for k in out):
        return [out[i] for i in range(len(out))]
    return out


def tree_map(fn, tree) -> dict:
    """fn(leaf) at each leaf of ``tree``."""
    return tree_build((path, fn(leaf)) for path, leaf in tree_paths(tree))


# ---------------------------------------------------------------- schedule


def cosine_schedule(step, *, base_lr: float, warmup: int, total: int,
                    min_ratio: float = 0.1) -> float:
    """Linear warmup to ``base_lr`` over ``warmup`` steps, then cosine
    decay to ``min_ratio * base_lr`` at ``total``; computed in float32 as
    the reference computes it, returned as a Python float (exactly that
    float32 value)."""
    f32 = np.float32
    step = f32(int(step))
    warm = np.minimum(step / f32(max(warmup, 1)), f32(1.0))
    t = np.clip((step - f32(warmup)) / f32(max(total - warmup, 1)),
                f32(0.0), f32(1.0))
    cos = f32(min_ratio) + f32(1 - min_ratio) * f32(0.5) * (
        f32(1.0) + np.cos(f32(np.pi) * t))
    return float(f32(base_lr) * warm * f32(cos))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares over every leaf, a float32 0-d tensor on
    the leaves' device (no host sync)."""
    sums = [torch.sum(torch.square(leaf.float())) for _, leaf in tree_paths(tree)]
    return torch.sqrt(torch.stack(sums).sum())


def _clip_scale(n, max_norm: float):
    return torch.clamp(max_norm / torch.clamp(n, min=1e-9), max=1.0)


def clip_by_global_norm(tree, max_norm: float):
    """(tree scaled by min(1, max_norm / max(norm, 1e-9)), norm)."""
    n = global_norm(tree)
    scale = _clip_scale(n, max_norm)
    return tree_map(lambda leaf: (leaf * scale).to(leaf.dtype), tree), n


def clip_by_global_norm_(tree, max_norm: float):
    """``clip_by_global_norm`` in place: each leaf scaled in its own
    storage (the same products); returns the norm."""
    n = global_norm(tree)
    scale = _clip_scale(n, max_norm)
    for _, leaf in tree_paths(tree):
        leaf.mul_(scale)
    return n


# ---------------------------------------------------------------- int8 blocks


def _q8(x):
    """f32 (n,) padded to BLOCK -> (codes int8, scales f32 (n/BLOCK,))."""
    xb = x.reshape(-1, BLOCK)
    scale = torch.clamp(xb.abs().amax(dim=-1), min=1e-12) / 127.0
    codes = torch.clamp(torch.round(xb / scale[:, None]), -127, 127)
    return codes.to(torch.int8).reshape(-1), scale


def _dq8(codes, scale):
    return (codes.reshape(-1, BLOCK).float() * scale[:, None]).reshape(-1)


def _pad_flat(x):
    """(flat float32 zero-padded to a multiple of BLOCK, unpadded length)."""
    flat = x.reshape(-1).float()
    pad = (-flat.shape[0]) % BLOCK
    return torch.nn.functional.pad(flat, (0, pad)), flat.shape[0]


def _last_dim_blocks(shape) -> bool:
    """Shape-preserving quantization applies when the last dim blocks
    evenly (the reference keeps every leading dim, and its sharding)."""
    return len(shape) >= 1 and shape[-1] % BLOCK == 0


def _q8_nd(x):
    """(..., D) f32 -> (codes int8 (..., D), scales f32 (..., D/BLOCK))."""
    xb = x.reshape(x.shape[:-1] + (x.shape[-1] // BLOCK, BLOCK))
    scale = torch.clamp(xb.abs().amax(dim=-1), min=1e-12) / 127.0
    codes = torch.clamp(torch.round(xb / scale[..., None]), -127, 127)
    return codes.to(torch.int8).reshape(x.shape), scale


def _dq8_nd(codes, scale):
    shape = codes.shape
    xb = codes.reshape(shape[:-1] + (shape[-1] // BLOCK, BLOCK)).float()
    return (xb * scale[..., None]).reshape(shape)


# ---------------------------------------------------------------- AdamW


def adamw_init(params, *, int8_state: bool = False) -> dict:
    """{"mu": a tree like ``params`` of {"m", "v"} (float32) or {"m_q",
    "m_s", "v_q", "v_s"} (int8), "step": 0-d int32 on the host}."""
    def leaf(p):
        zeros = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        if int8_state:
            zc, zs = (_q8_nd(zeros) if _last_dim_blocks(p.shape)
                      else _q8(_pad_flat(zeros)[0]))
            return {"m_q": zc, "m_s": zs, "v_q": torch.zeros_like(zc),
                    "v_s": zs.clone()}
        return {"m": zeros, "v": torch.zeros_like(zeros)}
    return {"mu": tree_map(leaf, params),
            "step": torch.zeros((), dtype=torch.int32)}


def _bias_corrections(state, b1: float, b2: float):
    """(t, c1, c2): the step after this update and 1 - b^t in float32."""
    step = int(state["step"]) + 1
    f32 = np.float32
    return (step, float(f32(1.0) - f32(b1) ** f32(step)),
            float(f32(1.0) - f32(b2) ** f32(step)))


def _plain_update(p, g, s, *, lr, b1, b2, eps, weight_decay, int8_state,
                  c1, c2):
    """One leaf's (new p, new moments {name: tensor}) on tensors whose
    int8 blocks each lie whole on this rank; nothing written."""
    def finish(upd, p):
        p32 = p.float()
        return (p32 - lr * (upd + weight_decay * p32)).to(p.dtype)

    g32 = torch.zeros(p.shape, device=p.device) if g is None else g.float()
    if not int8_state:
        m = b1 * s["m"] + (1 - b1) * g32
        v = b2 * s["v"] + (1 - b2) * torch.square(g32)
        upd = (m / c1) / (torch.sqrt(v / c2) + eps)
        return finish(upd, p), {"m": m, "v": v}
    # v is quantized in the sqrt domain: linear absmax codes would round
    # its small entries to 0 and explode the 1/(sqrt(v)+eps) step
    if _last_dim_blocks(p.shape):
        m = _dq8_nd(s["m_q"], s["m_s"])
        v = torch.square(_dq8_nd(s["v_q"], s["v_s"]))
        m = b1 * m + (1 - b1) * g32
        v = b2 * v + (1 - b2) * torch.square(g32)
        upd = (m / c1) / (torch.sqrt(v / c2) + eps)
        mq, ms = _q8_nd(m)
        vq, vs = _q8_nd(torch.sqrt(v))
    else:
        flat_g, n = _pad_flat(g32)
        m = _dq8(s["m_q"], s["m_s"])
        v = torch.square(_dq8(s["v_q"], s["v_s"]))
        m = b1 * m + (1 - b1) * flat_g
        v = b2 * v + (1 - b2) * torch.square(flat_g)
        upd = ((m / c1) / (torch.sqrt(v / c2) + eps))[:n].reshape(p.shape)
        mq, ms = _q8(m)
        vq, vs = _q8(torch.sqrt(v))
    return finish(upd, p), {"m_q": mq, "m_s": ms, "v_q": vq, "v_s": vs}


def _leaf_update(p, g, s, **kw):
    """One leaf's (new p, new moments {name: tensor}); nothing written."""
    leaf = lambda p, g, s: _plain_update(p, g, s, **kw)
    # int8 blocks that a DTensor's shards would cut through: a sharded
    # last dim whose block count does not split over its ranks
    # (``_joined_leaf``), or the flat layout (the leaf made whole,
    # updated, and each rank keeping its own shard of the result: no
    # collective back)
    if not kw["int8_state"] or not is_dtensor(p) or _blocks_local(p):
        return leaf(p, g, s)
    if _last_dim_blocks(p.shape):
        return _joined_leaf(leaf, p, g, s)
    new_p, new_s = leaf(_whole(p), None if g is None else _whole(g),
                        {k: _whole(v) for k, v in s.items()})
    return (_reshard_like(new_p, p),
            {k: _reshard_like(v, s[k]) for k, v in new_s.items()})


def _whole(t):
    return t.full_tensor() if is_dtensor(t) else t


def adamw_update(grads, state, params, *, lr, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.01, int8_state: bool = False):
    """Returns (new_params, new_state); nothing is written in place. A
    None gradient is a zero one (the reference differentiates every leaf:
    an unused one, like the encoder's ``lm_head``, gets zeros, so only
    its weight decay moves it). ``lr`` a float (or 0-d tensor)."""
    step, c1, c2 = _bias_corrections(state, b1, b2)
    kw = dict(lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
              int8_state=int8_state, c1=c1, c2=c2)
    out = [(path, _leaf_update(p, tree_get(grads, path),
                               tree_get(state["mu"], path), **kw))
           for path, p in tree_paths(params)]
    new_params = tree_build((path, o[0]) for path, o in out)
    new_mu = tree_build((path, o[1]) for path, o in out)
    return new_params, {"mu": new_mu,
                        "step": torch.tensor(step, dtype=torch.int32)}


def adamw_update_(grads, state, params, *, lr, b1: float = 0.9,
                  b2: float = 0.95, eps: float = 1e-8,
                  weight_decay: float = 0.01, int8_state: bool = False,
                  stacked=()):
    """``adamw_update`` with the state donated: the new parameters and
    moments are written into ``params``' and ``state``'s own storages, a
    leaf at a time, with the same arithmetic in the same order (the bits
    equal the functional step's, int8 codes included). Each leaf's
    gradient is dropped from ``grads`` once it is used, so that the
    caller's tree empties as the update goes. A leaf under a top-level
    key in ``stacked`` (a layer stack, layers on dim 0) whose dim 0 is not
    split and whose update is elementwise along it (float32 moments, or
    int8 blocks along the last dim) goes a layer at a time, so that only
    one layer's temporaries are live. Returns (params, state): the
    caller's trees, ``state["step"]`` advanced."""
    step, c1, c2 = _bias_corrections(state, b1, b2)
    kw = dict(lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
              int8_state=int8_state, c1=c1, c2=c2)
    for path, p in tree_paths(params):
        node = tree_get(grads, path[:-1])
        g = node[path[-1]]
        node[path[-1]] = None
        s = tree_get(state["mu"], path)
        layers = (path[0] in stacked and p.ndim >= 2 and not _split_dim0(p))
        if int8_state and not _last_dim_blocks(p.shape):
            _write_flat(p, g, s, kw, layers and p[0].numel() % BLOCK == 0)
        elif layers:
            for i in range(p.shape[0]):
                _write(p[i], None if g is None else g[i],
                       {k: v[i] for k, v in s.items()}, kw)
        else:
            _write(p, g, s, kw)
        del g
    state["step"] = torch.tensor(step, dtype=torch.int32)
    return params, state


def _write_flat(p, g, s, kw, layers: bool) -> None:
    """An int8 leaf in the flat layout (its blocks run over the flattened
    leaf, across the shards of a DTensor): the moments made whole once,
    then, with ``layers`` (a stack whose layers each hold whole blocks,
    so that no block straddles two), a layer at a time: that layer's
    parameter and gradient made whole, updated, written back; else the
    whole leaf at once, as ``adamw_update`` does. Each rank keeps its own
    shard of the new moments."""
    whole = {k: _whole(v) for k, v in s.items()}
    if layers:
        n = p[0].numel()
        parts = [(p[i], None if g is None else g[i],
                  {k: v[i * n // (BLOCK if k.endswith("_s") else 1):
                        (i + 1) * n // (BLOCK if k.endswith("_s") else 1)]
                   for k, v in whole.items()})
                 for i in range(p.shape[0])]
    else:
        parts = [(p, g, whole)]
    for p_i, g_i, s_i in parts:
        new_p, new_s = _plain_update(_whole(p_i),
                                     None if g_i is None else _whole(g_i),
                                     s_i, **kw)
        _assign(p_i, new_p)
        for k, v in new_s.items():
            s_i[k].copy_(v)
        del new_p, new_s
    for k, v in whole.items():
        _assign(s[k], v)


def _split_dim0(p) -> bool:
    from torch.distributed.tensor import Shard
    return is_dtensor(p) and any(isinstance(pl, Shard) and pl.dim == 0
                                 for pl in p.placements)


def _write(p, g, s, kw) -> None:
    """One leaf's (or layer's) update, written into p and s's tensors."""
    new_p, new_s = _leaf_update(p, g, s, **kw)
    _assign(p, new_p)
    for k, v in new_s.items():
        _assign(s[k], v)


def _assign(dst, src) -> None:
    """dst's values := src's, in dst's own storage (a DTensor's local
    shard; src placed as dst is, or whole on every rank: each rank takes
    its own shard of it)."""
    if is_dtensor(dst):
        if not is_dtensor(src):
            src = _reshard_like(src, dst)
        elif src.placements != dst.placements:
            src = src.redistribute(dst.device_mesh, dst.placements)
        dst, src = dst.to_local(), src.to_local()
    with torch.no_grad():
        dst.copy_(src)


def _blocks_local(p) -> bool:
    """True when every int8 block of DTensor ``p``'s state lies on one
    rank: the nd layout with the last dim whole, or split over ranks that
    divide its block count."""
    from torch.distributed.tensor import Shard
    if not _last_dim_blocks(p.shape):
        return False
    n = 1
    for i, pl in enumerate(p.placements):
        if isinstance(pl, Shard) and pl.dim in (-1, p.ndim - 1):
            n *= p.device_mesh.size(i)
    return (p.shape[-1] // BLOCK) % n == 0


def _joined_leaf(leaf, p, g, s):
    """``leaf(p, g, s)`` for a DTensor whose last dim is split across int8
    block boundaries: that dim made whole (the rest stays split), updated,
    and split again. A stacked leaf (layers on an unsplit dim 0) goes a
    layer at a time, so that only one layer's moments sit joined."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = p.device_mesh
    last = (-1, p.ndim - 1)
    if p.ndim >= 3 and not any(isinstance(pl, Shard) and pl.dim == 0
                               for pl in p.placements):
        outs = [_joined_leaf(leaf, p[i], None if g is None else g[i],
                             {k: v[i] for k, v in s.items()})
                for i in range(p.shape[0])]
        return (torch.stack([o[0] for o in outs]),
                {k: torch.stack([o[1][k] for o in outs]) for k in s})
    rows = [Replicate() if isinstance(pl, Shard) and pl.dim in last else pl
            for pl in p.placements]
    joined = lambda t: t.redistribute(mesh, rows) if t.shape == p.shape else t
    new_p, new_s = leaf(joined(p), None if g is None else joined(g),
                        {k: joined(v) for k, v in s.items()})
    return (new_p.redistribute(mesh, p.placements),
            {k: v.redistribute(mesh, s[k].placements)
             for k, v in new_s.items()})


def _reshard_like(t, like):
    """Whole tensor ``t`` (the same on every rank) as a DTensor placed like
    ``like``: each rank keeps its own shard, nothing crosses ranks."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(t, like.device_mesh, like.placements,
                             src_data_rank=None)


def adam_state_bytes(n_params: int, int8: bool) -> int:
    """Planning helper: the moments' bytes for ``n_params`` parameters."""
    if int8:
        return int(n_params * (2 + 8 / BLOCK))  # 2 int8 codes + 2 f32/BLOCK scales
    return n_params * 8


def state_bytes(opt: dict) -> int:
    """The bytes the moments of ``adamw_init``'s state actually hold
    (padding of the flat int8 leaves included)."""
    return sum(t.numel() * t.element_size() for _, t in tree_paths(opt["mu"]))
