"""The port's LM stack against the JAX package's, on the CPU: configs, the
registry, parameter trees with MoE blocks and the MTP head, the GShard MoE,
MLA and GQA attention, ``forward`` with its aux, ``embed_pooled`` and the
windowed plain attention.

Inputs are made from a numpy seed; the reference's parameters cross
through ``convert.from_reference_params``. Tolerances: float32 copies of
the configs (``dtype="float32"``) within 1e-5 absolute and relative for a
module and 1e-4 over the stack. The configs' own bf16: each module and
each block, fed the same input, within 2e-2 absolute and relative; over
the stack the two packages round in different places and the errors
compound, so there the largest difference is held within 2e-2 of the
tensor's largest value and every row's cosine at 0.99 or more (dense
archs), and every row's cosine at 0.95 or more (MoE archs: a token whose
router scores sit near a tie can take another expert once the stacks
have drifted by an ulp). The MoE's expert
ids, kept set and ``dropped_frac`` are compared exactly in float32, under
both dispatch modes and both router scores.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro_torch.configs import registry as preg  # noqa: E402
from repro_torch.configs.base import MoEConfig  # noqa: E402
from repro_torch.core.convert import (bind_reference_layout,  # noqa: E402
                                      from_reference_params, stack_layers)
from repro_torch.kernels.flash_attention import flash_attention_plain  # noqa: E402
from repro_torch.models import attention as pattn  # noqa: E402
from repro_torch.models import moe as pmoe  # noqa: E402
from repro_torch.models import transformer as ptr  # noqa: E402

LM_ARCHS = ["stablelm-1.6b", "h2o-danube-1.8b", "stablelm-3b",
            "deepseek-v2-lite-16b", "deepseek-v3-671b"]
MODULE_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
STACK_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def to_torch(x):
    """A jax/numpy array -> a CPU tensor of the same dtype (bf16 by bits)."""
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":
        return torch.tensor(arr.view(np.int16)).view(torch.bfloat16)
    return torch.tensor(arr)


def jit(fn, *static):
    """The reference's function jitted, ``cfg`` and ``static`` static."""
    return jax.jit(fn, static_argnames=("cfg",) + static)


J_INIT = jax.jit(jtr.init, static_argnums=0)
J_FORWARD = jit(jtr.forward)
J_LOGITS = jit(jtr.logits_from_hidden)
J_BLOCK = jit(jtr._block_fwd, "is_moe")
J_POOLED = jit(jtr.embed_pooled)
J_MOE = jit(jmoe.apply_moe, "capacity_factor", "router_score")


def cfg_of(arch, dtype):
    cfg = jreg.get_arch(arch).smoke
    return cfg if dtype == "bfloat16" else dataclasses.replace(cfg, dtype=dtype)


def port_model(jparams, cfg):
    """The port's model holding the reference's parameters."""
    model = ptr.init(cfg, torch.Generator().manual_seed(0), "cpu")
    model.load_state_dict(
        from_reference_params(jax.tree.map(np.asarray, jparams), cfg),
        strict=True)
    return model


_MODELS = {}


def models(arch):
    """(reference params, port model) for the arch's SMOKE config, made
    once (both dtypes share the float32 parameters)."""
    if arch not in _MODELS:
        cfg = jreg.get_arch(arch).smoke
        jp = J_INIT(cfg, jax.random.PRNGKey(0))
        _MODELS[arch] = (jp, port_model(jp, cfg))
    return _MODELS[arch]


def assert_close(got, want, tol, what=""):
    np.testing.assert_allclose(f32(got), f32(want), atol=tol, rtol=tol,
                               err_msg=what)


BF16_STACK_COS = {"dense": 0.99, "moe": 0.95}


def assert_same_drops(got, want, n_assignments):
    """``dropped_frac`` equal as a count of kept assignments (XLA's jit
    divides by a reciprocal, so the float may differ in its last bit)."""
    kept = [round((1.0 - float(x)) * n_assignments) for x in (got, want)]
    assert kept[0] == kept[1], (float(got), float(want))
    assert abs(float(got) - float(want)) <= 1e-7


def assert_stack_close(got, want, dtype, cfg, what=""):
    """The stack's bound (see the module docstring): elementwise in
    float32; in bf16 rows' cosine, and for dense archs the largest
    difference against the largest value."""
    if dtype == "float32":
        return assert_close(got, want, STACK_TOL[dtype], what)
    a = f32(got).reshape(-1, f32(got).shape[-1])
    b = f32(want).reshape(a.shape)
    cos = (a * b).sum(-1) / np.maximum(
        np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1), 1e-30)
    assert cos.min() >= BF16_STACK_COS["moe" if cfg.moe else "dense"], (
        what, cos.min())
    if cfg.moe is None:
        err = np.abs(a - b).max() / np.abs(b).max()
        assert err <= STACK_TOL[dtype], (what, err)


# ----------------------------------------------------------- configs


@pytest.mark.parametrize("arch", LM_ARCHS)
@pytest.mark.parametrize("which", ["full", "smoke"])
def test_lm_configs_equal_the_reference(arch, which):
    got = getattr(preg.get_arch(arch), which)
    want = getattr(jreg.get_arch(arch), which)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.n_params() == want.n_params()
    assert preg.get_arch(arch).family == "lm"


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_parameter_counts_match_the_reference(arch):
    """The port's own init holds as many parameters, leaf for leaf in
    shape and dtype, as the reference's tree (MoE and MTP included)."""
    cfg = preg.get_arch(arch).smoke
    model = ptr.init(cfg, torch.Generator().manual_seed(0), "cpu")
    jp, _ = models(arch)
    tree = stack_layers(model.state_dict(), cfg)
    got = {jax.tree_util.keystr(k): (tuple(v.shape), str(v.dtype)[6:])
           for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
    want = {jax.tree_util.keystr(k): (tuple(v.shape), str(v.dtype))
            for k, v in jax.tree_util.tree_flatten_with_path(jp)[0]}
    assert got == want


# ----------------------------------------------------------- parameter trees


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "deepseek-v3-671b"])
def test_moe_and_mtp_trees_cross_leaf_for_leaf(arch):
    """Every reference leaf reaches the port's state_dict (strict load),
    the expert axis kept, and ``stack_layers`` gives the reference's tree
    back array for array; binding the layout for training stacks the MoE
    and MTP leaves too, each layer's parameter a view of its slice."""
    jp, model = models(arch)
    cfg = jreg.get_arch(arch).smoke
    sd = model.state_dict()
    m = cfg.moe
    assert sd["moe_blocks.0.moe.experts.w_up"].shape == (
        m.n_routed, cfg.d_model, m.d_ff_expert)
    assert sd["moe_blocks.1.moe.router"].shape == (cfg.d_model, m.n_routed)
    tree = stack_layers(sd, cfg)
    flat_j = dict(jax.tree_util.tree_flatten_with_path(jp)[0])
    n = 0
    for path, leaf in flat_j.items():
        node = tree
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
        n += 1
    assert n == len(jax.tree.leaves(jp))
    if cfg.mtp_depth:
        assert sd["mtp.0.proj"].shape == (2 * cfg.d_model, cfg.d_model)
    fresh = port_model(jp, cfg)
    bound = bind_reference_layout(fresh, cfg)
    w_up = bound["moe_blocks"]["moe"]["experts"]["w_up"]
    assert w_up.shape == (cfg.n_moe_layers, m.n_routed, cfg.d_model,
                          m.d_ff_expert)
    with torch.no_grad():
        w_up[1, 2].fill_(0.5)
        if cfg.mtp_depth:
            bound["mtp"]["proj"][0].fill_(0.25)
    assert bool((fresh.moe_blocks[1].moe.experts.w_up[2] == 0.5).all())
    if cfg.mtp_depth:
        assert bool((fresh.mtp[0].proj == 0.25).all())
    for path, leaf in flat_j.items():
        node = bound
        for k in path:
            node = node[k.key]
        if path[0].key == "moe_blocks" and path[-1].key == "w_up":
            continue
        if path[0].key == "mtp" and path[-1].key == "proj":
            continue
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))


def test_stack_count_mismatch_is_refused():
    jp, _ = models("deepseek-v2-lite-16b")
    cfg = jreg.get_arch("deepseek-v2-lite-16b").smoke
    with pytest.raises(ValueError, match="moe_blocks"):
        from_reference_params(jax.tree.map(np.asarray, jp),
                              dataclasses.replace(cfg, n_layers=4))


# ----------------------------------------------------------- MoE


def moe_inputs(cfg, T, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(2, T // 2, cfg.d_model)) * scale).astype(np.float32)


def kept_oracle(idx, E, C):
    """The GShard assignment by a loop: slots in order over k, tokens in
    order within a group; an expert's queue counts its dropped tokens."""
    G, t, k = idx.shape
    kept = np.zeros((G, t, k), bool)
    for g in range(G):
        count = np.zeros(E, int)
        for j in range(k):
            for i in range(t):
                e = idx[g, i, j]
                kept[g, i, j] = count[e] < C
                count[e] += 1
    return kept


MOE_CASES = [
    # (label, MoE overrides, capacity_factor, router weight scale)
    ("dropping", dict(n_routed=8, top_k=2, group_size=16), 0.5, 40.0),
    ("dropless", dict(n_routed=8, top_k=2, group_size=32), None, 1.0),
    ("groups_ragged", dict(n_routed=6, top_k=3, group_size=20), 1.0, 20.0),
]


@pytest.mark.parametrize("dispatch", ["einsum", "gather"])
@pytest.mark.parametrize("router_score", ["softmax", "sigmoid"])
@pytest.mark.parametrize("label,over,cf,wscale", MOE_CASES,
                         ids=[c[0] for c in MOE_CASES])
def test_apply_moe_matches_reference(label, over, cf, wscale, router_score,
                                     dispatch):
    """apply_moe in float32: y within 1e-5, aux within 1e-5, dropped_frac
    equal; the expert ids equal the reference's ``_routing``; the kept set
    equals a loop over the GShard rule (and implies dropped_frac). The
    'dropping' cases drop tokens."""
    base = jreg.get_arch("deepseek-v2-lite-16b").smoke
    moe = dataclasses.replace(base.moe, dispatch=dispatch, **over)
    cfg = dataclasses.replace(base, dtype="float32", moe=moe)
    jp = jmoe.init_moe(jax.random.PRNGKey(3), cfg, jnp.float32)
    jp["router"] = jp["router"] * wscale
    p = pmoe.MoE(torch.Generator().manual_seed(0), cfg)
    p.load_state_dict(from_reference_params(jax.tree.map(np.asarray, jp), cfg),
                      strict=True)
    p.requires_grad_(False)
    T = 80 if label == "groups_ragged" else 64
    x = moe_inputs(cfg, T, seed=len(label))
    jy, jaux = J_MOE(jp, cfg, jnp.asarray(x), capacity_factor=cf,
                     router_score=router_score)
    py, paux = pmoe.apply_moe(p, cfg, torch.tensor(x), capacity_factor=cf,
                              router_score=router_score)
    assert_close(py, jy, MODULE_TOL["float32"], "y")
    for name in ("load_balance", "router_z"):
        assert_close(paux[name], jaux[name], MODULE_TOL["float32"], name)
    assert_same_drops(paux["dropped_frac"], jaux["dropped_frac"],
                      T * moe.top_k)

    G, t, C = pmoe.group_shape(T, moe, cf)
    logits = torch.tensor(x).reshape(G, t, -1) @ p.router
    _, pidx = pmoe._routing(logits, moe, router_score)
    _, jidx = jmoe._routing(jnp.asarray(logits.numpy()), moe, router_score)
    np.testing.assert_array_equal(pidx.numpy(), np.asarray(jidx))
    _, keeps = pmoe._assign(pidx, moe.n_routed, C)
    kept = torch.stack(keeps, -1).numpy()
    np.testing.assert_array_equal(kept, kept_oracle(pidx.numpy(),
                                                     moe.n_routed, C))
    assert float(paux["dropped_frac"]) == pytest.approx(
        1 - kept.sum() / kept.size, abs=1e-7)
    if label != "dropless":
        assert float(jaux["dropped_frac"]) > 0.05
    else:
        assert float(jaux["dropped_frac"]) == 0.0


def test_routing_ties_take_the_lower_expert():
    """Equal router scores select the lower expert id first, as
    ``jax.lax.top_k``."""
    moe = MoEConfig(n_routed=6, top_k=3)
    logits = torch.tensor([[[0.0, 1.0, 1.0, 0.0, 1.0, 1.0]]])
    for score in ("softmax", "sigmoid"):
        _, idx = pmoe._routing(logits, moe, score)
        _, jidx = jmoe._routing(jnp.asarray(logits.numpy()), moe, score)
        assert idx.tolist() == [[[1, 2, 4]]] == np.asarray(jidx).tolist()


@pytest.mark.parametrize("dispatch", ["einsum", "gather"])
def test_apply_moe_bf16_matches_reference(dispatch):
    """The configs' bf16: dispatch in bf16, combine cast to bf16."""
    base = jreg.get_arch("deepseek-v2-lite-16b").smoke
    cfg = dataclasses.replace(base, moe=dataclasses.replace(
        base.moe, dispatch=dispatch))
    jp = jmoe.init_moe(jax.random.PRNGKey(4), cfg, jnp.float32)
    p = pmoe.MoE(torch.Generator().manual_seed(0), cfg)
    p.load_state_dict(from_reference_params(jax.tree.map(np.asarray, jp), cfg),
                      strict=True)
    p.requires_grad_(False)
    x = moe_inputs(cfg, 64, seed=9)
    jy, jaux = J_MOE(jp, cfg, jnp.asarray(x, jnp.bfloat16))
    py, paux = pmoe.apply_moe(p, cfg, torch.tensor(x).to(torch.bfloat16))
    assert py.dtype == torch.bfloat16
    assert_close(py, jy, MODULE_TOL["bfloat16"])
    assert_same_drops(paux["dropped_frac"], jaux["dropped_frac"],
                      64 * cfg.moe.top_k)


# ----------------------------------------------------------- attention


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "deepseek-v3-671b"])
def test_mla_attention_matches_reference(arch, dtype):
    """MLA prefill (with and without a q low rank) with return_kv: out and
    the latent cache entries."""
    cfg = cfg_of(arch, dtype)
    jp, model = models(arch)
    jl = jax.tree.map(lambda a: a[0], jp["moe_blocks"])["attn"]
    pl = model.moe_blocks[0].attn
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 24, cfg.d_model)).astype(np.float32)
    jx, tx = jnp.asarray(x, JDT[dtype]), torch.tensor(x).to(TDT[dtype])
    pos = np.arange(24)
    jo, (jc, jr) = jattn.mla_attention(jl, cfg, jx, jnp.asarray(pos),
                                       return_kv=True)
    po, (pc, pr) = pattn.mla_attention(pl, cfg, tx, torch.tensor(pos),
                                       return_kv=True)
    tol = MODULE_TOL[dtype]
    assert_close(po, jo, tol, "out")
    assert_close(pc, jc, tol, "c_kv")
    assert_close(pr, jr, tol, "k_rope")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["stablelm-1.6b", "h2o-danube-1.8b"])
def test_gqa_attention_return_kv_matches_reference(arch, dtype):
    cfg = cfg_of(arch, dtype)
    jp, model = models(arch)
    jl = jax.tree.map(lambda a: a[1], jp["dense_blocks"])["attn"]
    pl = model.dense_blocks[1].attn
    x = np.random.default_rng(6).normal(size=(2, 40, cfg.d_model)).astype(
        np.float32)
    jx, tx = jnp.asarray(x, JDT[dtype]), torch.tensor(x).to(TDT[dtype])
    jo, (jk, jv) = jattn.gqa_attention(jl, cfg, jx, jnp.arange(40),
                                       return_kv=True)
    po, (pk, pv) = pattn.gqa_attention(pl, cfg, tx, torch.arange(40),
                                       return_kv=True)
    tol = MODULE_TOL[dtype]
    for got, want in ((po, jo), (pk, jk), (pv, jv)):
        assert_close(got, want, tol)


def window_inputs(seed, B, S, H, KV, dh):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, S, H, dh)).astype(np.float32)
    k = rng.normal(size=(B, S, KV, dh)).astype(np.float32)
    v = rng.normal(size=(B, S, KV, dh)).astype(np.float32)
    pos = np.arange(S)
    mask = np.stack([pos < S,                          # every key
                     pos < S - 5,                      # ragged
                     (pos < S // 3) | (pos >= 2 * S // 3),  # a hole
                     np.zeros(S, bool)])[:B]           # fully masked
    return q, k, v, mask


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [1, 17, 64])
def test_windowed_plain_attention_matches_reference(window, causal):
    """The port's windowed plain attention (``flash_attention_plain``, the
    kernel's CPU twin, and ``_chunked_attention``) against the reference's
    ``_dense_attention`` and ``_chunked_attention`` with ``window=``:
    rows fully masked inside their window (the hole) and a fully masked
    row average v over every key. The Pallas kernel has no window to
    compare against."""
    B, S, H, KV, dh = 4, 96, 4, 2, 16
    q, k, v, mask = window_inputs(window, B, S, H, KV, dh)
    scale = dh ** -0.5
    jq = jnp.asarray(q).reshape(B, S, KV, H // KV, dh)
    kw = dict(scale=scale, causal=causal, window=window, q_offset=0,
              kv_mask=jnp.asarray(mask))
    want_dense = jattn._dense_attention(jq, jnp.asarray(k), jnp.asarray(v), **kw)
    want_chunk = jattn._chunked_attention(jq, jnp.asarray(k), jnp.asarray(v),
                                          q_chunk=32, k_chunk=32, **kw)
    got = flash_attention_plain(torch.tensor(q), torch.tensor(k),
                                torch.tensor(v), causal=causal, scale=scale,
                                kv_mask=torch.tensor(mask), window=window)
    tq = torch.tensor(q).reshape(B, S, KV, H // KV, dh)
    got_chunk = pattn._chunked_attention(
        tq, torch.tensor(k), torch.tensor(v), scale=scale, causal=causal,
        window=window, q_offset=0, q_chunk=32, k_chunk=32,
        kv_mask=torch.tensor(mask))
    tol = MODULE_TOL["float32"]
    assert_close(got, np.asarray(want_dense).reshape(B, S, H, dh), tol)
    assert_close(got, np.asarray(want_chunk).reshape(B, S, H, dh), tol)
    assert_close(got_chunk, want_chunk, tol)
    # the fully masked row is the mean of v over every key
    np.testing.assert_allclose(
        f32(got)[3], np.repeat(v[3].mean(0), H // KV, axis=0)[None].repeat(S, 0),
        atol=1e-5)


# ----------------------------------------------------------- the stack


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_forward_and_aux_match_reference(arch, dtype):
    """forward (a padding mask on one row): hidden states within the
    stack's tolerance, the MoE aux within it and dropped_frac equal."""
    cfg = cfg_of(arch, dtype)
    jp, model = models(arch)
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, cfg.vocab_size, size=(2, 40))
    mask = np.ones((2, 40), bool)
    mask[1, 29:] = False
    jh, jaux = J_FORWARD(jp, cfg, jnp.asarray(tokens),
                         kv_mask=jnp.asarray(mask))
    ph, paux = ptr.forward(model, cfg, torch.tensor(tokens),
                           kv_mask=torch.tensor(mask))
    assert ph.dtype == TDT[dtype]
    tol = STACK_TOL[dtype]
    assert_stack_close(ph, jh, dtype, cfg, "hidden")
    for name in ("load_balance", "router_z"):
        assert_close(paux[name], jaux[name], tol, name)
    if cfg.moe:
        assert_same_drops(paux["dropped_frac"], jaux["dropped_frac"],
                          80 * cfg.moe.top_k)
    # the head on the same hidden states: a module
    jl = J_LOGITS(jp, cfg, jh[:, -3:])
    assert_close(ptr.logits_from_hidden(model, cfg, to_torch(jh[:, -3:])), jl,
                 MODULE_TOL[dtype], "logits")


NEAR_TIE = 1e-3  # relative gap between the k-th and (k+1)-th router score


def near_tie_tokens(blk, cfg, x, positions, mask):
    """(B, S) bool: tokens whose k-th and (k+1)-th router scores (on the
    port's own MoE input) lie within NEAR_TIE of each other, where an ulp
    of bf16 upstream can swap the k-th expert."""
    h = ptr._attention(cfg)(blk.attn, cfg, ptr.apply_norm(blk.attn_norm, x),
                            positions, kv_mask=mask)
    y_in = ptr.apply_norm(blk.mlp_norm, x + h)
    logits = y_in.float().reshape(-1, cfg.d_model) @ blk.moe.router.float()
    scores = (torch.sigmoid(logits) if ptr._router_score(cfg) == "sigmoid"
              else torch.softmax(logits, dim=-1))
    top = scores.sort(dim=-1, descending=True).values
    k = cfg.moe.top_k
    gap = top[:, k - 1] - top[:, k]
    return (gap <= NEAR_TIE * top[:, k - 1]).reshape(x.shape[:2]).numpy()


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_each_block_bf16_matches_reference(arch):
    """Every block (attention, norms, MLP or MoE) in the config's bf16,
    fed the same input as the reference's, within 2e-2. In an MoE block a
    token at a near-tie of its k-th router score (at most 1 in 20) is left
    out: XLA fuses the residual add into the norm, and the ulp it saves
    can swap that expert."""
    cfg = cfg_of(arch, "bfloat16")
    jp, model = models(arch)
    rng = np.random.default_rng(10)
    x = rng.normal(size=(2, 40, cfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16)
    mask = np.ones((2, 40), bool)
    mask[1, 31:] = False
    for i, blk in enumerate(model.layers()):
        is_moe = blk.moe is not None
        li = i - cfg.n_dense_layers if is_moe else i
        jb = jax.tree.map(lambda a: a[li], jp["moe_blocks" if is_moe
                                              else "dense_blocks"])
        jy, ja = J_BLOCK(cfg, jb, jx, jnp.arange(40), jnp.asarray(mask),
                         is_moe=is_moe)
        tx, tmask = to_torch(jx), torch.tensor(mask)
        py, pa = ptr._block_fwd(cfg, blk, tx, torch.arange(40), tmask)
        keep = np.ones((2, 40), bool)
        if is_moe:
            keep = ~near_tie_tokens(blk, cfg, tx, torch.arange(40), tmask)
            assert keep.mean() >= 0.95, keep.mean()
        assert_close(f32(py)[keep], f32(jy)[keep], MODULE_TOL["bfloat16"],
                     f"block {i}")
        if is_moe:
            assert_same_drops(pa["dropped_frac"], ja["dropped_frac"],
                              80 * cfg.moe.top_k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_embed_pooled_matches_reference(arch, dtype):
    """The vector-DB tower on an LM: mean pooling under a padding mask
    (one row a single token)."""
    cfg = cfg_of(arch, dtype)
    jp, model = models(arch)
    rng = np.random.default_rng(8)
    tokens = rng.integers(1, cfg.vocab_size, size=(3, 36))
    lengths = np.array([36, 20, 1])
    mask = np.arange(36)[None, :] < lengths[:, None]
    tokens = np.where(mask, tokens, 0)
    want = J_POOLED(jp, cfg, jnp.asarray(tokens), jnp.asarray(mask))
    got = ptr.embed_pooled(model, cfg, torch.tensor(tokens),
                           torch.tensor(mask))
    assert got.dtype == torch.float32 and got.shape == (3, cfg.d_model)
    assert_stack_close(got, want, dtype, cfg)


def test_registry_ports_the_lm_family():
    for arch in LM_ARCHS:
        assert preg.get_config(arch, smoke=True).name.endswith("-smoke")
    # every arch of the reference registry resolves, in its own family
    for arch in jreg.list_archs():
        e, je = preg.get_arch(arch), jreg.get_arch(arch)
        assert e.family == je.family
        assert dataclasses.asdict(e.full) == dataclasses.asdict(je.full)
