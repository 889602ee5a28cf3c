"""The encoder's training in the port against the JAX package's, on the CPU.

From the reference's seeded parameters (carried across by
``convert.from_reference_params``) and the same numpy batches:

  * ``contrastive_loss`` and its gradients against ``jax.value_and_grad``
    for ``thistle_sbert.SMOKE`` (S = 16 takes the dense attention, S = 64
    the checkpointed chunked one) and FULL cut to 2 layers at full width:
    float32 copies of the config (``dtype="float32"``) within 1e-5
    relative on the loss and 1e-4 x max|g_ref| on each leaf; the shipped
    bf16 configs within 2e-2 on the loss and cosine >= 0.99 on each
    nonzero leaf; ``lm_head``'s gradient exactly zero on both sides;
  * the in-batch accuracy's ties, ``remat``, and accumulation over
    micro-batches against the reference's.

Whole train steps, train states and runs: ``test_torch_train_state.py``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import thistle_sbert as jcfg  # noqa: E402
from repro.models import encoder as jenc  # noqa: E402
from repro.train import accum as jaccum  # noqa: E402
from repro_torch.configs import thistle_sbert as pcfg  # noqa: E402
from repro_torch.core import convert  # noqa: E402
from repro_torch.models import encoder as penc  # noqa: E402
from repro_torch.train import accum as paccum  # noqa: E402

FULL2 = dict(n_layers=2)  # FULL at full width, cut to 2 layers
_PARAMS = {}


def _configs(name, dtype, **over):
    jc = dataclasses.replace(getattr(jcfg, name), dtype=dtype, **over)
    pc = dataclasses.replace(getattr(pcfg, name), dtype=dtype, **over)
    return jc, pc


def _reference_params(jc):
    key = (jc.name, jc.n_layers)
    if key not in _PARAMS:
        _PARAMS[key] = jax.tree.map(np.asarray, jenc.init(jc, jax.random.PRNGKey(7)))
    return _PARAMS[key]


def _port_model(jc, pc):
    model = penc.init(pc, torch.Generator().manual_seed(0), device="cpu",
                      trainable=True)
    model.load_state_dict(convert.from_reference_params(_reference_params(jc), pc),
                          strict=True)
    return model


def _batch(B, S, vocab, seed=0):
    """Ragged masks, every text at least one token long (a fully padded
    text gives the reference NaN gradients: the norm of its zero vector;
    ROADMAP.md Queue 3 D)."""
    rng = np.random.default_rng(seed)
    out = {}
    for side in ("q", "p"):
        tok = rng.integers(2, vocab, size=(B, S)).astype(np.int32)
        lengths = rng.integers(1, S + 1, size=B)
        mask = np.arange(S)[None, :] < lengths[:, None]
        out[f"{side}_tokens"] = np.where(mask, tok, 0)
        out[f"{side}_mask"] = mask
    return out


def _pt(batch):
    return {k: torch.tensor(v) for k, v in batch.items()}


def _jx(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _check_grads(got: dict, want_tree, pc, dtype):
    want = convert.from_reference_params(jax.tree.map(np.asarray, want_tree), pc)
    assert set(got) == set(want)
    assert not torch.any(got["lm_head.w"]) and not torch.any(want["lm_head.w"])
    for name, g in got.items():
        g, w = g.numpy(), want[name].float().numpy()
        scale = np.abs(w).max()
        if scale == 0:
            assert not np.any(g), name
        elif dtype == "float32":
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * scale,
                                       err_msg=name)
        else:
            cos = (g * w).sum() / np.linalg.norm(g) / np.linalg.norm(w)
            assert cos >= 0.99, (name, cos)


LOSS_CASES = [("SMOKE", {}, 16, 8), ("SMOKE", {}, 64, 8), ("FULL", FULL2, 24, 4)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,over,S,B", LOSS_CASES)
def test_contrastive_loss_and_grads_match_reference(name, over, S, B, dtype):
    jc, pc = _configs(name, dtype, **over)
    batch = _batch(B, S, pc.vocab_size)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jenc.contrastive_loss(p, jc, b), has_aux=True))(
            _reference_params(jc), _jx(batch))
    model = _port_model(jc, pc)
    (loss, metrics), grads = paccum.value_and_grad(
        lambda m, b: penc.contrastive_loss(m, pc, b), model, _pt(batch))
    rel = 1e-5 if dtype == "float32" else 2e-2
    assert float(loss) == pytest.approx(float(jl), rel=rel)
    assert float(metrics["loss"]) == float(loss)
    if dtype == "float32":
        assert float(metrics["in_batch_acc"]) == float(jm["in_batch_acc"])
    _check_grads(grads, jg, pc, dtype)


def test_in_batch_accuracy_takes_the_first_of_tied_scores():
    """Every passage the same text: each row of sims ties, the argmax is
    column 0 on both sides, so only query 0 counts as right."""
    jc, pc = _configs("SMOKE", "float32")
    batch = _batch(6, 16, pc.vocab_size, seed=3)
    for k in ("p_tokens", "p_mask"):
        batch[k] = np.repeat(batch[k][:1], 6, axis=0)
    _, jm = jenc.contrastive_loss(_reference_params(jc), jc, _jx(batch))
    with torch.no_grad():
        _, m = penc.contrastive_loss(_port_model(jc, pc), pc, _pt(batch))
    assert float(m["in_batch_acc"]) == float(jm["in_batch_acc"])
    assert float(m["in_batch_acc"]) == pytest.approx(1 / 6)


def test_remat_recomputes_the_same_grads():
    """``remat=True`` (each block checkpointed) gives the gradients of the
    plain graph, at S = 64 (the chunked attention's kv steps checkpointed
    inside)."""
    jc, pc = _configs("SMOKE", "float32")
    model = _port_model(jc, pc)
    batch = _pt(_batch(4, 64, pc.vocab_size, seed=1))
    runs = [paccum.value_and_grad(
        lambda m, b, r=remat: penc.contrastive_loss(m, pc, b, remat=r),
        model, batch) for remat in (False, True)]
    assert float(runs[0][0][0]) == float(runs[1][0][0])
    for name, g in runs[0][1].items():
        torch.testing.assert_close(runs[1][1][name], g, rtol=1e-6, atol=1e-7)


def test_encode_builds_a_graph_only_to_train():
    jc, pc = _configs("SMOKE", "float32")
    model = _port_model(jc, pc)
    b = _pt(_batch(3, 16, pc.vocab_size))
    assert penc.encode(model, pc, b["q_tokens"], b["q_mask"]).grad_fn is None
    emb = penc.encode(model, pc, b["q_tokens"], b["q_mask"], train=True)
    assert emb.grad_fn is not None


@pytest.mark.parametrize("n_micro", [2, 4])
def test_gradient_accumulation_on_the_encoder_matches_reference(n_micro):
    jc, pc = _configs("SMOKE", "float32")
    batch = _batch(8, 16, pc.vocab_size, seed=2)
    jg, jl, jm = jax.jit(lambda p, b: jaccum.gradient_accumulation(
        lambda pp, bb: jenc.contrastive_loss(pp, jc, bb), p, b, n_micro))(
            _reference_params(jc), _jx(batch))
    g, loss, m = paccum.gradient_accumulation(
        lambda mdl, b: penc.contrastive_loss(mdl, pc, b), _port_model(jc, pc),
        _pt(batch), n_micro)
    assert float(loss) == pytest.approx(float(jl), rel=1e-5)
    assert float(m["in_batch_acc"]) == pytest.approx(float(jm["in_batch_acc"]))
    _check_grads(g, jg, pc, "float32")
