"""The port's LM serving path against the JAX package's, on the CPU:
``init_cache``, ``prefill`` (logits and every cache array), ``decode_step``
(logits and cache, a step past the sliding window, a wrapped GQA cache and
MLA's clamped write) and ``DecodeLoop`` (greedy tokens equal; temperature
sampling by shape and range, since the random streams differ).

The reference's parameters cross through ``convert.from_reference_params``.
Float32 copies of the SMOKE configs within 1e-4 absolute and relative
over the stack; the configs' own bf16 within 2e-2 of the largest value
and every row's cosine (a cache's row: one layer of one sequence) at 0.99
or more for dense archs, and every row's cosine at 0.95 or more for MoE
archs, where a near-tie of router scores
can send a token to another expert once the two stacks have drifted by
an ulp (``tests/test_torch_lm.py`` holds each block elementwise).
``decode_step`` is fed the reference's own cache, so its comparison
starts from equal inputs.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.serve.decode import DecodeLoop as JDecodeLoop  # noqa: E402
from repro_torch.core.convert import from_reference_params  # noqa: E402
from repro_torch.models import transformer as ptr  # noqa: E402
from repro_torch.serve import DecodeLoop  # noqa: E402

LM_ARCHS = ["stablelm-1.6b", "h2o-danube-1.8b", "stablelm-3b",
            "deepseek-v2-lite-16b", "deepseek-v3-671b"]
STACK_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
BF16_ROW_COS = {"dense": 0.99, "moe": 0.95}
WINDOW = 32  # h2o-danube SMOKE's window

J_INIT = jax.jit(jtr.init, static_argnums=0)
J_PREFILL = jax.jit(jtr.prefill, static_argnames=("cfg",))
J_DECODE = jax.jit(jtr.decode_step, static_argnames=("cfg",))


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def to_torch(x):
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":
        return torch.tensor(arr.view(np.int16)).view(torch.bfloat16)
    return torch.tensor(arr)


def cfg_of(arch, dtype):
    cfg = jreg.get_arch(arch).smoke
    return cfg if dtype == "bfloat16" else dataclasses.replace(cfg, dtype=dtype)


_MODELS = {}


def models(arch):
    """(reference params, port model holding them), made once an arch."""
    if arch not in _MODELS:
        cfg = jreg.get_arch(arch).smoke
        jp = J_INIT(cfg, jax.random.PRNGKey(0))
        model = ptr.init(cfg, torch.Generator().manual_seed(0), "cpu")
        model.load_state_dict(
            from_reference_params(jax.tree.map(np.asarray, jp), cfg),
            strict=True)
        _MODELS[arch] = (jp, model)
    return _MODELS[arch]


def assert_stack_close(got, want, dtype, cfg, what=""):
    a, b = f32(got), f32(want)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    if dtype == "float32":
        np.testing.assert_allclose(a, b, atol=STACK_TOL[dtype],
                                   rtol=STACK_TOL[dtype], err_msg=what)
        return
    # rows: a cache's (layer, batch) slices, the logits' batch rows
    rows = a.shape[0] * a.shape[1] if a.ndim >= 4 else -1
    a = a.reshape(rows, -1) if a.ndim >= 4 else a.reshape(-1, a.shape[-1])
    b = b.reshape(a.shape)
    live = np.abs(b).max(-1) > 0  # an empty slot is zero on both sides
    assert (np.abs(a[~live]) == 0).all(), what
    cos = (a * b).sum(-1)[live] / (np.linalg.norm(a, axis=-1)
                                   * np.linalg.norm(b, axis=-1))[live]
    assert cos.min() >= BF16_ROW_COS["moe" if cfg.moe else "dense"], (
        what, cos.min())
    if cfg.moe is None:
        err = np.abs(a - b).max() / np.abs(b).max()
        assert err <= STACK_TOL[dtype], (what, err)


def prompt(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S))


def pad_cache(cache, n):
    return jax.tree.map(
        lambda c: jnp.pad(c, ((0, 0), (0, 0), (0, n)) + ((0, 0),) * (c.ndim - 3)),
        cache)


# ----------------------------------------------------------- the cache


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_init_cache_matches_reference(arch):
    for max_len in (20, 64):
        cfg = jreg.get_arch(arch).smoke
        want = jtr.init_cache(cfg, 3, max_len)
        got = ptr.init_cache(cfg, 3, max_len, device="cpu")
        assert sorted(got) == sorted(want)
        for name in want:
            assert tuple(got[name].shape) == want[name].shape, name
            assert str(got[name].dtype)[6:] == str(want[name].dtype)
            assert not got[name].any()
    if cfg.window:
        assert got["k"].shape[2] == cfg.window


# ----------------------------------------------------------- prefill

PREFILL_CASES = ([(a, 24) for a in LM_ARCHS if a != "h2o-danube-1.8b"]
                 + [("h2o-danube-1.8b", S) for S in (20, WINDOW, 45)])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch,S", PREFILL_CASES)
def test_prefill_matches_reference(arch, S, dtype):
    """Last-token logits and every cache array, in the reference's
    layout: danube's window below, at and past the window (padded to W,
    full, rolled by S % W)."""
    cfg = cfg_of(arch, dtype)
    jp, model = models(arch)
    tokens = prompt(cfg, 2, S, seed=S)
    jl, jc = J_PREFILL(jp, cfg, jnp.asarray(tokens))
    pl, pc = ptr.prefill(model, cfg, torch.tensor(tokens))
    assert pl.shape == (2, 1, cfg.vocab_size)
    assert_stack_close(pl, jl, dtype, cfg, "logits")
    assert sorted(pc) == sorted(jc)
    for name in jc:
        assert pc[name].dtype == getattr(torch, cfg.dtype)
        assert_stack_close(pc[name], jc[name], dtype, cfg, name)
    if cfg.window:
        assert pc["k"].shape[2] == WINDOW


# ----------------------------------------------------------- decode_step

DECODE_CASES = [
    # (arch, prompt S, slots appended to the prefill cache, label)
    ("stablelm-1.6b", 24, 4, "grown"),
    ("stablelm-1.6b", 24, 0, "full cache wraps to slot 0"),
    ("stablelm-3b", 24, 4, "grown"),
    ("h2o-danube-1.8b", 20, 0, "ring below the window"),
    ("h2o-danube-1.8b", 45, 0, "ring past the window"),
    ("deepseek-v2-lite-16b", 24, 4, "grown"),
    ("deepseek-v2-lite-16b", 24, 0, "MLA clamp to the last slot"),
    ("deepseek-v3-671b", 24, 4, "grown"),
    ("deepseek-v3-671b", 24, 0, "MLA clamp to the last slot"),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch,S,grow,label", DECODE_CASES,
                         ids=[f"{c[0]}-{c[1]}-{c[2]}" for c in DECODE_CASES])
def test_decode_step_matches_reference(arch, S, grow, label, dtype):
    """decode_step at position S from the reference's prefill cache:
    logits and the written cache. A full GQA cache wraps (slot S % C);
    danube writes its ring at S % W; a full MLA cache writes slot C - 1,
    as the reference's clamped dynamic_update_slice does."""
    cfg = cfg_of(arch, dtype)
    jp, model = models(arch)
    tokens = prompt(cfg, 2, S + 1, seed=100 + S)
    _, jc = J_PREFILL(jp, cfg, jnp.asarray(tokens[:, :S]))
    if grow:
        jc = pad_cache(jc, grow)
    pc = {n: to_torch(c).clone() for n, c in jc.items()}
    jl, jc2 = J_DECODE(jp, cfg, jnp.asarray(tokens[:, S:]), jc, jnp.int32(S))
    pl, pc2 = ptr.decode_step(model, cfg, torch.tensor(tokens[:, S:]), pc, S)
    assert_stack_close(pl, jl, dtype, cfg, "logits")
    for name in jc2:
        assert_stack_close(pc2[name], jc2[name], dtype, cfg, name)
    C = next(iter(jc.values())).shape[2]
    slot = S % C if not cfg.mla else min(S, C - 1)
    changed = [i for i in range(C) if not np.array_equal(
        f32(pc2[next(iter(pc2))][:, :, i]), f32(jc[next(iter(jc))][:, :, i]))]
    assert changed == [slot], (label, changed)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_decode_after_prefill_matches_a_longer_prefill(arch):
    """The reference's own check (tests/test_smoke_archs.py), on the port:
    decode at S after prefill(S) against prefill(S + 1)'s last logits."""
    cfg = cfg_of(arch, "float32")
    _, model = models(arch)
    tokens = torch.tensor(prompt(cfg, 2, 40, seed=7))
    full, _ = ptr.prefill(model, cfg, tokens)
    _, cache = ptr.prefill(model, cfg, tokens[:, :39])
    if cfg.window is None:
        cache = {n: ptr.pad_slots(c, 43) for n, c in cache.items()}
    dec, _ = ptr.decode_step(model, cfg, tokens[:, 39:], cache, 39)
    np.testing.assert_allclose(f32(dec), f32(full), atol=1e-4, rtol=1e-4)


# ----------------------------------------------------------- DecodeLoop

LOOP_CASES = [
    # (arch, prompt S, n_new, max_len): the cache is grown to max_len, or
    # to min(max_len, window); S + n_new past it wraps a GQA cache and
    # clamps an MLA one, as in the reference
    ("stablelm-1.6b", 10, 8, 24),
    ("stablelm-1.6b", 10, 6, 12),
    ("stablelm-3b", 10, 8, 24),
    ("h2o-danube-1.8b", 10, 8, 24),
    ("h2o-danube-1.8b", 28, 10, 64),
    ("deepseek-v2-lite-16b", 10, 8, 24),
    ("deepseek-v2-lite-16b", 10, 6, 12),
    ("deepseek-v3-671b", 10, 8, 24),
]


@pytest.mark.parametrize("arch,S,n_new,max_len", LOOP_CASES)
def test_decode_loop_greedy_tokens_equal_reference(arch, S, n_new, max_len):
    cfg = cfg_of(arch, "float32")
    jp, model = models(arch)
    tokens = prompt(cfg, 2, S, seed=S + n_new)
    want = JDecodeLoop(jp, cfg, max_len=max_len).generate(
        jnp.asarray(tokens), n_new=n_new)
    got = DecodeLoop(model, cfg, max_len=max_len, device="cpu").generate(
        torch.tensor(tokens), n_new=n_new)
    assert got.shape == (2, n_new) and got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_decode_loop_temperature_sampling():
    """Sampled tokens: shape, range, repeatable from a seeded generator,
    seed 0 when none is given, and not the greedy run at a high
    temperature."""
    arch = "h2o-danube-1.8b"
    cfg = cfg_of(arch, "float32")
    _, model = models(arch)
    loop = DecodeLoop(model, cfg, max_len=40, device="cpu")
    tokens = torch.tensor(prompt(cfg, 3, 12, seed=1))

    def sample(seed):
        return loop.generate(tokens, n_new=10, temperature=5.0,
                             generator=torch.Generator().manual_seed(seed))

    a, b = sample(0), sample(0)
    assert a.shape == (3, 10)
    assert int(a.min()) >= 0 and int(a.max()) < cfg.vocab_size
    assert torch.equal(a, b)
    assert torch.equal(loop.generate(tokens, n_new=10, temperature=5.0), a)
    assert not torch.equal(sample(1), a)
    assert not torch.equal(loop.generate(tokens, n_new=10), a)


def test_serving_runs_on_the_card_by_default(monkeypatch):
    """Without a card, ``init`` and ``DecodeLoop`` with no device raise;
    parameters on another device than the loop's are refused."""
    cfg = cfg_of("stablelm-1.6b", "float32")
    _, model = models("stablelm-1.6b")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ptr.init(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        DecodeLoop(model, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        ptr.init_cache(cfg, 1, 8)
    with pytest.raises(ValueError, match="parameters lie on"):
        DecodeLoop(model, cfg, device="meta")
