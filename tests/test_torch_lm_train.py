"""LM training in the port against the JAX package's, on the CPU.

From the reference's seeded parameters (carried across by
``convert.from_reference_params``) and the same numpy batches, for all
five LM archs at SMOKE:

  * ``transformer.loss_fn``'s value, metrics (``ce``, ``dropped_frac``,
    ``mtp_ce``, ``loss``) and gradients against
    ``jax.value_and_grad(repro.models.transformer.loss_fn)``: float32
    copies of the configs within 1e-5 relative on the loss and 1e-4 x
    max|g_ref| on each leaf (the stack's bound); the shipped bf16 configs
    within 2e-2 on the loss and each leaf's gradient cosine >= 0.99 (dense
    archs) or >= 0.95 (MoE archs: a token at a router near-tie may take
    another expert once the stacks have drifted by an ulp). The MoE
    SMOKE configs are dropless (capacity factor 8); the MoE archs are also
    run in float32 at a capacity that drops;
  * labels of -100 ignored, and an all-ignored batch (the loss is then
    the aux losses alone); the MTP head (deepseek-v3); remat equal to no
    remat and to the reference's remat on the chunked attention;
  * an MoE + MTP train state across both packages' checkpoint stores,
    one whole step (clip, cosine schedule, AdamW) against the reference's
    jitted step, and a ``--fail-at`` restart bit-equal to an uninterrupted
    run.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import CheckpointStore as JaxStore  # noqa: E402
from repro.configs import registry as jreg  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.train import optim as jopt  # noqa: E402
from repro_torch.checkpoint import CheckpointStore  # noqa: E402
from repro_torch.configs import registry as preg  # noqa: E402
from repro_torch.core import convert  # noqa: E402
from repro_torch.ft import FailureInjector, Supervisor  # noqa: E402
from repro_torch.launch.train import ArchJob  # noqa: E402
from repro_torch.models import transformer as ptr  # noqa: E402
from repro_torch.train import accum as paccum  # noqa: E402
from repro_torch.train import optim as popt  # noqa: E402
from repro_torch.train.job import ModelJob  # noqa: E402

LM_ARCHS = ["stablelm-1.6b", "h2o-danube-1.8b", "stablelm-3b",
            "deepseek-v2-lite-16b", "deepseek-v3-671b"]
MOE_ARCHS = ["deepseek-v2-lite-16b", "deepseek-v3-671b"]
# The reference's side is jitted at XLA's backend optimization level 0:
# the same HLO, compiled in about 40 % of the time (compiles are most of
# this file's run).
FAST_COMPILE = {"xla_backend_optimization_level": 0}
J_INIT = jax.jit(jtr.init, static_argnums=0, compiler_options=FAST_COMPILE)
J_VG = jax.jit(jax.value_and_grad(jtr.loss_fn, has_aux=True),
               static_argnames=("cfg", "remat"),
               compiler_options=FAST_COMPILE)
_PARAMS = {}


def configs(arch, dtype="float32", **moe):
    """(reference cfg, port cfg): the arch's SMOKE at ``dtype``, its MoE
    fields replaced by ``moe``."""
    out = []
    for reg in (jreg, preg):
        cfg = dataclasses.replace(reg.get_arch(arch).smoke, dtype=dtype)
        if moe:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                                   **moe))
        out.append(cfg)
    return tuple(out)


def ref_params(arch):
    if arch not in _PARAMS:
        cfg = jreg.get_arch(arch).smoke
        _PARAMS[arch] = jax.tree.map(np.asarray,
                                     J_INIT(cfg, jax.random.PRNGKey(3)))
    return _PARAMS[arch]


def port_model(arch, pc):
    model = ptr.init(pc, torch.Generator().manual_seed(0), "cpu",
                     trainable=True)
    model.load_state_dict(convert.from_reference_params(ref_params(arch), pc),
                          strict=True)
    return model


def lm_batch(vocab, B=2, S=16, seed=0, ignored=0.2):
    """Tokens, their next tokens as labels, the last position and a share
    ``ignored`` of the others -100."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, vocab, size=(B, S + 1)).astype(np.int32)
    labels = tok[:, 1:].copy()
    labels[rng.random((B, S)) < ignored] = -100
    labels[:, -1] = -100
    return {"tokens": tok[:, :-1], "labels": labels}


def jx(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def pt(batch):
    return {k: torch.tensor(v) for k, v in batch.items()}


def both(arch, jc, pc, batch, remat=False):
    """((loss, metrics), grads by name) from each package."""
    (jl, jm), jg = J_VG(jax.tree.map(jnp.asarray, ref_params(arch)), cfg=jc,
                        batch=jx(batch), remat=remat)
    want = convert.from_reference_params(jax.tree.map(np.asarray, jg), pc)
    model = port_model(arch, pc)
    (loss, metrics), grads = paccum.value_and_grad(
        lambda m, b: ptr.loss_fn(m, pc, b, remat=remat), model, pt(batch))
    return (jl, jm, want), (loss, metrics, grads)


def check_grads(got, want, tol=None, cos_min=None):
    assert set(got) == set(want)
    for name, g in got.items():
        g, w = g.numpy(), want[name].float().numpy()
        scale = np.abs(w).max()
        if scale == 0:
            assert np.abs(g).max() <= 1e-12, name
        elif tol is not None:
            np.testing.assert_allclose(g, w, rtol=0, atol=tol * scale,
                                       err_msg=name)
        else:
            cos = (g * w).sum() / np.linalg.norm(g) / np.linalg.norm(w)
            assert cos >= cos_min, (name, cos)


def check_metrics(jm, metrics, pc, tokens, rel):
    assert set(metrics) == set(jm)
    for name in ("ce", "loss", "mtp_ce"):
        if name in jm:
            assert float(metrics[name]) == pytest.approx(float(jm[name]),
                                                         rel=rel), name
    if pc.moe is not None:  # as a count of kept assignments
        n = tokens.size * pc.moe.top_k * pc.n_moe_layers
        kept = [round((1.0 - float(x)) * n)
                for x in (metrics["dropped_frac"], jm["dropped_frac"])]
        if rel == 1e-5:
            assert kept[0] == kept[1]
    else:
        assert float(metrics["dropped_frac"]) == float(jm["dropped_frac"]) == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_loss_and_grads_match_reference(arch, dtype):
    jc, pc = configs(arch, dtype)
    batch = lm_batch(pc.vocab_size, seed=1)
    (jl, jm, want), (loss, metrics, grads) = both(arch, jc, pc, batch)
    rel = 1e-5 if dtype == "float32" else 2e-2
    assert float(loss) == pytest.approx(float(jl), rel=rel)
    check_metrics(jm, metrics, pc, batch["tokens"], rel)
    if dtype == "float32":
        check_grads(grads, want, tol=1e-4)
    else:
        check_grads(grads, want, cos_min=0.95 if pc.moe else 0.99)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_loss_at_a_dropping_capacity(arch):
    """capacity_factor 1.0 with one group of all 32 tokens: some experts
    overflow; the kept set, aux losses and gradients match in float32."""
    jc, pc = configs(arch, capacity_factor=1.0)
    batch = lm_batch(pc.vocab_size, seed=2)
    (jl, jm, want), (loss, metrics, grads) = both(arch, jc, pc, batch)
    assert float(metrics["dropped_frac"]) > 0
    assert float(loss) == pytest.approx(float(jl), rel=1e-5)
    check_metrics(jm, metrics, pc, batch["tokens"], 1e-5)
    check_grads(grads, want, tol=1e-4)


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "deepseek-v2-lite-16b"])
def test_all_ignored_labels_leave_the_aux_losses(arch):
    """Every label -100: ce is 0 over a denominator of 1, the loss is the
    MoE's aux losses alone (0 for a dense arch), and the gradients are
    theirs, as in the reference."""
    jc, pc = configs(arch)
    batch = lm_batch(pc.vocab_size, seed=3, ignored=1.0)
    (jl, jm, want), (loss, metrics, grads) = both(arch, jc, pc, batch)
    assert float(metrics["ce"]) == 0.0 == float(jm["ce"])
    assert float(loss) == pytest.approx(float(jl), rel=1e-5, abs=1e-12)
    if pc.moe is None:
        assert float(loss) == 0.0
        assert all(not torch.any(g) for g in grads.values())
    else:
        assert float(loss) > 0
    check_grads(grads, want, tol=1e-4)


def test_mtp_head_adds_its_weighted_loss():
    """deepseek-v3's depth-1 MTP head: ``mtp_ce`` equals the reference's,
    the loss is ce + aux + mtp_loss_weight * mtp_ce, and every MTP leaf
    gets a gradient."""
    arch = "deepseek-v3-671b"
    jc, pc = configs(arch)
    batch = lm_batch(pc.vocab_size, seed=4)
    (jl, jm, want), (loss, metrics, grads) = both(arch, jc, pc, batch)
    assert float(metrics["mtp_ce"]) == pytest.approx(float(jm["mtp_ce"]),
                                                     rel=1e-5)
    model = port_model(arch, pc)
    _, aux = ptr.forward(model, pc, pt(batch)["tokens"])
    total = (float(metrics["ce"]) + float(aux["load_balance"])
             + float(aux["router_z"]) + pc.mtp_loss_weight
             * float(metrics["mtp_ce"]))
    assert float(loss) == pytest.approx(total, rel=1e-6)
    mtp = [n for n in grads if n.startswith("mtp.0.")]
    assert len(mtp) >= 10 and all(torch.any(grads[n]) for n in mtp)
    check_grads({n: grads[n] for n in mtp}, {n: want[n] for n in mtp},
                tol=1e-4)


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "deepseek-v3-671b"])
def test_remat_equals_no_remat(arch):
    """At S = 64 (the SMOKE configs' chunk threshold: the checkpointed
    chunked attention) the port's per-block remat gives the loss and
    gradients of no remat, and the reference's remat=True."""
    jc, pc = configs(arch)
    batch = lm_batch(pc.vocab_size, B=1, S=64, seed=5)
    (jl, _, want), (loss, _, grads) = both(arch, jc, pc, batch, remat=True)
    model = port_model(arch, pc)
    (loss0, _), grads0 = paccum.value_and_grad(
        lambda m, b: ptr.loss_fn(m, pc, b), model, pt(batch))
    assert float(loss) == float(loss0)
    for name, g in grads.items():
        torch.testing.assert_close(g, grads0[name], rtol=1e-6, atol=1e-9)
    assert float(loss) == pytest.approx(float(jl), rel=1e-5)
    check_grads(grads, want, tol=1e-4)


# ----------------------------------------------------------- steps, states


def _reference_update(state, grads, lr, total):
    grads, _ = jopt.clip_by_global_norm(grads, 1.0)
    lr_t = jopt.cosine_schedule(state["opt"]["step"], base_lr=lr, warmup=10,
                                total=total)
    params, opt = jopt.adamw_update(grads, state["opt"], state["params"],
                                    lr=lr_t)
    return {"params": params, "opt": opt}


_reference_update = jax.jit(_reference_update, compiler_options=FAST_COMPILE)


def reference_step(jc, lr, total):
    """The reference's step: ``J_VG`` (compiled once a config and shape,
    shared with the loss tests), then clip 1.0, the cosine schedule and
    AdamW, jitted."""
    def step(state, batch):
        (_, m), grads = J_VG(state["params"], cfg=jc, batch=batch,
                             remat=False)
        return _reference_update(state, grads, lr, total), m
    return step


def port_job(arch, pc, batches, lr=1e-2, total=20):
    return ModelJob(pc, port_model(arch, pc),
                    lambda m, b: ptr.loss_fn(m, pc, b), lambda s: batches[s],
                    lr=lr, warmup=10, total_steps=total, log_every=0)


def reference_state(arch, jc, steps, batches=()):
    state = {"params": jax.tree.map(jnp.asarray, ref_params(arch))}
    state["opt"] = jopt.adamw_init(state["params"])
    step = reference_step(jc, 1e-2, 20)
    for s in range(steps):
        state, _ = step(state, jx(batches[s]))
    return state


def assert_trees_equal(a, b):
    pa, pb = popt.tree_paths(a), popt.tree_paths(b)
    assert [p for p, _ in pa] == [p for p, _ in pb]
    for (path, x), (_, y) in zip(pa, pb):
        x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        y = y.numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape, path
        np.testing.assert_array_equal(x, y, err_msg=str(path))


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "deepseek-v3-671b"])
def test_train_steps_match_reference(arch):
    """Two whole steps (clip 1.0, cosine warmup 10, AdamW) from one state:
    the port's job over the reference's layout (MoE and MTP leaves
    stacked) against the reference's jitted step, float32."""
    jc, pc = configs(arch)
    batches = [lm_batch(pc.vocab_size, seed=10 + s) for s in range(2)]
    state = reference_state(arch, jc, 0)
    step = reference_step(jc, 1e-2, 20)
    job = port_job(arch, pc, batches)
    for s in range(2):
        state, jm = step(state, jx(batches[s]))
        m = job.run_step(s)
        assert m["loss"] == pytest.approx(float(jm["loss"]), rel=1e-5)
    got = convert.to_reference_train_state(job.state, pc)
    ref = jax.tree.map(np.asarray, state)
    for path, g in popt.tree_paths(got["params"]):
        w = popt.tree_get(ref["params"], path)
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-4 * np.abs(w).max() + 1e-7,
                                   err_msg=str(path))
    assert int(got["opt"]["step"]) == int(ref["opt"]["step"]) == 2


def test_moe_mtp_train_state_crosses_both_ways(tmp_path):
    """deepseek-v3 SMOKE (dense, MoE and MTP stacks): the port's state
    after a step restores in the reference's store leaf for leaf, and the
    reference's restores in the port's (the model's parameters written)."""
    arch = "deepseek-v3-671b"
    jc, pc = configs(arch)
    batches = [lm_batch(pc.vocab_size, seed=20 + s) for s in range(2)]
    job = port_job(arch, pc, batches)
    job.run_step(0)
    CheckpointStore(str(tmp_path / "port")).save(job.state, 1)
    like = reference_state(arch, jc, 0)
    restored, step = JaxStore(str(tmp_path / "port")).restore(like)
    assert step == 1
    assert_trees_equal(jax.tree.map(np.asarray, restored),
                       convert.to_reference_train_state(job.state, pc))

    state = jax.tree.map(np.asarray, reference_state(arch, jc, 1, batches))
    JaxStore(str(tmp_path / "ref")).save(state, 1)
    job = port_job(arch, pc, batches)
    assert job.load_state(CheckpointStore(str(tmp_path / "ref"))) == 1
    assert_trees_equal(convert.to_reference_train_state(job.state, pc), state)
    sd = convert.from_reference_params(state["params"], pc)
    for name, p in job.model.named_parameters():
        assert torch.equal(p.detach(), sd[name]), name
    assert_trees_equal(convert.from_reference_train_state(state, pc), state)
    with pytest.raises(ValueError, match="moe_blocks"):
        convert.from_reference_train_state(
            state, dataclasses.replace(pc, n_layers=5))


def test_fail_at_restart_replays_bit_for_bit(tmp_path):
    """The CLI's job for deepseek-v2-lite SMOKE: failures at steps 3 and 6
    with checkpoints every 2 end bit-equal to an uninterrupted run."""
    kw = dict(full=False, batch=2, seq_len=16, lr=1e-3, total_steps=8,
              device="cpu")
    plain = ArchJob("deepseek-v2-lite-16b", **kw)
    plain.log_every = 0
    for s in range(8):
        plain.run_step(s)
    job = ArchJob("deepseek-v2-lite-16b", fail_at=[3, 6], **kw)
    job.log_every = 0
    store = CheckpointStore(str(tmp_path), keep=2)
    out = Supervisor(job, store, total_steps=8, checkpoint_every=2).run()
    store.wait()
    assert out["final_step"] == 8 and out["n_retries"] == 2
    cfg = plain.cfg
    assert_trees_equal(convert.to_reference_train_state(job.state, cfg),
                       convert.to_reference_train_state(plain.state, cfg))
