"""The port's training substrate against the JAX package's, on the CPU.

Fed the same trees (made from a numpy seed), the port's schedule, clipping,
AdamW (float32 and int8 state), accumulation, blockwise codes and the
error-feedback all-reduce are held to the reference's:

  * ``cosine_schedule`` within 1e-6 at the reference test's steps;
  * AdamW after 3 steps, float32 state: params, m and v within 1e-6
    relative (of each leaf's largest magnitude); int8 state: codes equal in
    at least 99.99 % of entries and within 1 elsewhere, scales within 1e-6
    relative; an unused leaf (None gradient) decays as the reference
    decays a zero gradient;
  * blockwise codes and scales bit-equal, and the all-reduce's mean on a
    (1,) mesh against the reference's ``shard_map`` on its (1,) mesh, on
    (4,) of "cpu" against the reference's per-shard codes averaged.

Then the numpy ports (``TokenStream``, the straggler monitor), the
reference's supervisor tests on a toy job, the registry, the trainer CLI
as a subprocess, and the attention kernel refusing inputs that need a
gradient.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.data import lm as jlm  # noqa: E402
from repro.train import accum as jaccum  # noqa: E402
from repro.train import compress as jcomp  # noqa: E402
from repro.train import optim as jopt  # noqa: E402
from repro_torch.checkpoint import CheckpointStore  # noqa: E402
from repro_torch.configs import registry as preg  # noqa: E402
from repro_torch.core.distributed import make_mesh  # noqa: E402
from repro_torch.data import lm as plm  # noqa: E402
from repro_torch.ft import (FailureInjector, NodeFailure, StragglerMonitor,  # noqa: E402
                            Supervisor, TrainJob)
from repro_torch.kernels import flash_attention as pfa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.train import accum as paccum  # noqa: E402
from repro_torch.train import compress as pcomp  # noqa: E402
from repro_torch.train import optim as popt  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
# leaves of both int8 layouts: last dim a multiple of 128 (blocks kept in
# shape), and flat with padding, one of them stacked over two layers
SHAPES = {"a": (1000,), "b": {"w": (37, 5), "s": (3, 256)},
          "stack": {"wq": (2, 64, 4, 16), "scale": (2, 64)}}


def _np_tree(rng, shapes, scale=1.0):
    return {k: (_np_tree(rng, v, scale) if isinstance(v, dict) else
                (rng.normal(size=v) * scale).astype(np.float32))
            for k, v in shapes.items()}


def _map(fn, tree):
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _t(tree):
    return _map(torch.tensor, tree)


def _j(tree):
    return _map(jnp.asarray, tree)


def _paths(tree, prefix=()):
    out = []
    for k in sorted(tree):
        v = tree[k]
        out += (_paths(v, prefix + (k,)) if isinstance(v, dict)
                else [(prefix + (k,), np.asarray(v.numpy() if isinstance(
                    v, torch.Tensor) else v))])
    return out


# ----------------------------------------------------------- schedule, clip


@pytest.mark.parametrize("warmup,total", [(10, 100), (20, 300), (0, 50)])
def test_cosine_schedule_matches_reference(warmup, total):
    for step in (0, 1, 5, 10, 19, 20, 55, 100, 150, 299, 300, 400):
        got = popt.cosine_schedule(step, base_lr=3e-4, warmup=warmup,
                                   total=total)
        want = float(jopt.cosine_schedule(jnp.asarray(step), base_lr=3e-4,
                                          warmup=warmup, total=total))
        assert got == pytest.approx(want, abs=1e-6 * 3e-4, rel=1e-6), step


def test_cosine_schedule_shape():
    lrs = [popt.cosine_schedule(s, base_lr=1.0, warmup=10, total=100)
           for s in [0, 5, 10, 55, 100, 200]]
    assert lrs[0] == 0.0
    assert lrs[1] == pytest.approx(0.5)
    assert lrs[2] == pytest.approx(1.0)
    assert lrs[3] < 1.0
    assert lrs[4] == pytest.approx(0.1, abs=1e-6)  # min_ratio floor
    assert lrs[5] == pytest.approx(0.1, abs=1e-6)


@pytest.mark.parametrize("scale", [0.01, 100.0])
def test_clip_by_global_norm_matches_reference(scale):
    tree = _np_tree(np.random.default_rng(1), SHAPES, scale)
    got, n = popt.clip_by_global_norm(_t(tree), 1.0)
    want, wn = jopt.clip_by_global_norm(_j(tree), 1.0)
    assert float(n) == pytest.approx(float(wn), rel=1e-6)
    for (path, g), (_, w) in zip(_paths(got), _paths(want)):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6 * np.abs(w).max(),
                                   err_msg=str(path))
    ones = {"a": torch.ones(10) * 3.0}
    clipped, norm = popt.clip_by_global_norm(ones, 1.0)
    assert float(popt.global_norm(clipped)) == pytest.approx(1.0, rel=1e-5)
    assert float(norm) == pytest.approx(np.sqrt(90.0), rel=1e-5)


# ----------------------------------------------------------- AdamW


def _three_steps(int8, wd):
    """Both packages' AdamW over 3 steps of the same grads; an unused leaf
    ("stack/scale") gets None in the port and zeros in the reference."""
    rng = np.random.default_rng(2)
    params = _np_tree(rng, SHAPES)
    grads = [_np_tree(rng, SHAPES, 1e-2 * (i + 1)) for i in range(3)]
    for g in grads:
        g["stack"]["scale"] = np.zeros_like(g["stack"]["scale"])
    pp, ps = _t(params), popt.adamw_init(_t(params), int8_state=int8)
    jp, js = _j(params), jopt.adamw_init(_j(params), int8_state=int8)
    kw = dict(weight_decay=wd, int8_state=int8)
    for i, g in enumerate(grads):
        lr = popt.cosine_schedule(i, base_lr=1e-2, warmup=1, total=10)
        pg = _t(g)
        pg["stack"]["scale"] = None
        pp, ps = popt.adamw_update(pg, ps, pp, lr=lr, **kw)
        jlr = jopt.cosine_schedule(jnp.asarray(i), base_lr=1e-2, warmup=1,
                                   total=10)
        jp, js = jopt.adamw_update(_j(g), js, jp, lr=jlr, **kw)
    return pp, ps, jp, js


@pytest.mark.parametrize("int8", [False, True])
def test_adamw_in_place_equals_functional(int8):
    """``clip_by_global_norm_`` and ``adamw_update_`` (the donated step's
    pair) over 3 steps against the functional pair from the same state:
    every leaf bit for bit, written into the state's own storages, each
    used gradient dropped from its tree. "stack" goes a layer at a time
    (its int8 ``wq`` in the flat layout, whose layers hold whole blocks;
    its ``scale``, whose do not, whole); an unused leaf's gradient is
    None."""
    rng = np.random.default_rng(5)
    params = _np_tree(rng, SHAPES)
    grads = [_np_tree(rng, SHAPES, 3.0 * (i + 1)) for i in range(3)]
    fp, fs = _t(params), popt.adamw_init(_t(params), int8_state=int8)
    ip, is_ = _t(params), popt.adamw_init(_t(params), int8_state=int8)
    ptrs = [t.data_ptr() for _, t in popt.tree_paths([ip, is_["mu"]])]
    for i, g in enumerate(grads):
        lr = popt.cosine_schedule(i, base_lr=1e-2, warmup=1, total=10)
        fg, fn = popt.clip_by_global_norm(_t(g), 1.0)
        ig = _t(g)
        n = popt.clip_by_global_norm_(ig, 1.0)
        assert torch.equal(fn, n)
        fg["stack"]["scale"] = ig["stack"]["scale"] = None
        fp, fs = popt.adamw_update(fg, fs, fp, lr=lr, int8_state=int8)
        out = popt.adamw_update_(ig, is_, ip, lr=lr, int8_state=int8,
                                 stacked=("stack",))
        assert out[0] is ip and out[1] is is_
        assert popt.tree_paths(ig) == []  # every gradient dropped
    assert int(is_["step"]) == int(fs["step"]) == 3
    got, want = (popt.tree_paths([ip, is_["mu"]]),
                 popt.tree_paths([fp, fs["mu"]]))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        assert torch.equal(a, b), path
    assert [t.data_ptr() for _, t in got] == ptrs


@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_adamw_float32_state_matches_reference(wd):
    pp, ps, jp, js = _three_steps(False, wd)
    assert int(ps["step"]) == int(js["step"]) == 3
    for tree_p, tree_j in ((pp, jp), (ps["mu"], js["mu"])):
        for (path, got), (_, want) in zip(_paths(tree_p), _paths(tree_j)):
            np.testing.assert_allclose(got, want, rtol=1e-6,
                                       atol=1e-6 * np.abs(want).max(),
                                       err_msg=str(path))


@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_adamw_int8_state_matches_reference(wd):
    pp, ps, jp, js = _three_steps(True, wd)
    for (path, got), (_, want) in zip(_paths(pp), _paths(jp)):
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=str(path))
    n_codes = n_equal = 0
    for (path, got), (_, want) in zip(_paths(ps["mu"]), _paths(js["mu"])):
        assert got.shape == want.shape and got.dtype == want.dtype, path
        if path[-1] in ("m_q", "v_q"):
            diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
            assert diff.max() <= 1, path
            n_codes += diff.size
            n_equal += int((diff == 0).sum())
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=str(path))
    assert n_equal >= 0.9999 * n_codes, (n_equal, n_codes)


@pytest.mark.parametrize("int8", [False, True])
def test_unused_leaf_only_decays(int8):
    """A None gradient (the encoder's lm_head) leaves the moments at zero
    and moves the leaf by weight decay alone, as the reference's zeros."""
    p = {"w": torch.tensor(np.linspace(-1, 1, 256, dtype=np.float32))}
    state = popt.adamw_init(p, int8_state=int8)
    new, state = popt.adamw_update({"w": None}, state, p, lr=0.5,
                                   weight_decay=0.1, int8_state=int8)
    want = p["w"] - 0.5 * (0.0 + 0.1 * p["w"])
    assert torch.equal(new["w"], want)
    for path, t in popt.tree_paths(state["mu"]):
        if path[-1] in ("m", "v", "m_q", "v_q"):
            assert not torch.any(t), path


def _quadratic_problem(grad=False):
    key = jax.random.PRNGKey(0)
    W = np.asarray(jax.random.normal(key, (6, 4)))
    X = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (128, 6)))
    Y = X @ W

    def loss_fn(p, b):
        l = torch.mean((b["x"] @ p["w"] - b["y"]) ** 2)
        return l, {"loss": l}

    batch = {"x": torch.tensor(X), "y": torch.tensor(Y)}
    return {"w": torch.zeros((6, 4), requires_grad=grad)}, batch, loss_fn


@pytest.mark.parametrize("int8", [False, True])
def test_adamw_converges(int8):
    params, batch, loss_fn = _quadratic_problem(grad=True)
    state = popt.adamw_init(params, int8_state=int8)
    for _ in range(250):
        (loss, _), grads = paccum.value_and_grad(loss_fn, params, batch)
        new, state = popt.adamw_update(grads, state, params, lr=3e-2,
                                       weight_decay=0.0, int8_state=int8)
        params = {"w": new["w"].requires_grad_(True)}
    assert float(loss) < 1e-3, float(loss)


def test_int8_state_matches_f32_early():
    params, batch, loss_fn = _quadratic_problem(grad=True)
    p8 = pf = params
    s8 = popt.adamw_init(params, int8_state=True)
    sf = popt.adamw_init(params, int8_state=False)
    for _ in range(5):
        _, g8 = paccum.value_and_grad(loss_fn, p8, batch)
        _, gf = paccum.value_and_grad(loss_fn, pf, batch)
        p8, s8 = popt.adamw_update(g8, s8, p8, lr=1e-2, weight_decay=0.0,
                                   int8_state=True)
        pf, sf = popt.adamw_update(gf, sf, pf, lr=1e-2, weight_decay=0.0)
        p8 = {"w": p8["w"].requires_grad_(True)}
        pf = {"w": pf["w"].requires_grad_(True)}
    np.testing.assert_allclose(p8["w"].detach().numpy(),
                               pf["w"].detach().numpy(), atol=5e-3, rtol=5e-2)


def test_adam_state_bytes_planning():
    n = 671_000_000_000
    assert popt.adam_state_bytes(n, int8=False) == jopt.adam_state_bytes(n, False)
    assert popt.adam_state_bytes(n, int8=True) == jopt.adam_state_bytes(n, True)
    assert popt.adam_state_bytes(n, int8=True) < n * 2.1
    p = {"a": torch.zeros(1000), "b": torch.zeros((4, 256))}
    assert popt.state_bytes(popt.adamw_init(p)) == 2024 * 8
    # flat leaf: 1000 -> 1024 codes and 8 scales, each moment
    assert popt.state_bytes(popt.adamw_init(p, int8_state=True)) == (
        2 * (1024 + 8 * 4) + 2 * (1024 + 8 * 4))


# ----------------------------------------------------------- accumulation


@pytest.mark.parametrize("n_micro", [1, 2, 4, 8])
def test_grad_accum_matches_reference(n_micro):
    params, batch, loss_fn = _quadratic_problem()
    w = np.asarray(jax.random.normal(jax.random.PRNGKey(2), (6, 4)))
    params = {"w": torch.tensor(w, requires_grad=True)}
    g, l, m = paccum.gradient_accumulation(loss_fn, params, batch, n_micro)
    g1, l1, _ = paccum.gradient_accumulation(loss_fn, params, batch, 1)

    def jloss(p, b):
        l = jnp.mean((b["x"] @ p["w"] - b["y"]) ** 2)
        return l, {"loss": l}

    jb = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    jg, jl, jm = jaccum.gradient_accumulation(jloss, {"w": jnp.asarray(w)}, jb,
                                              n_micro)
    np.testing.assert_allclose(float(l), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(g["w"].numpy(), np.asarray(jg["w"]),
                               rtol=1e-4, atol=1e-5)
    # micro-batches of a per-sample mean give the full batch's gradient
    np.testing.assert_allclose(float(l1), float(l), rtol=1e-5)
    np.testing.assert_allclose(g1["w"].numpy(), g["w"].numpy(),
                               rtol=1e-4, atol=1e-5)
    assert g["w"].dtype == torch.float32


def test_grad_accum_refuses_a_ragged_split():
    params, batch, loss_fn = _quadratic_problem(grad=True)
    with pytest.raises(ValueError, match="micro-batches"):
        paccum.gradient_accumulation(loss_fn, params, batch, 3)


# ----------------------------------------------------------- compression


def test_blockwise_codes_equal_reference(rng):
    tree = {"a": rng.normal(size=(1000,)).astype(np.float32),
            "b": (rng.normal(size=(37, 5)) * 100).astype(np.float32),
            "c": rng.normal(size=(4, 256)).astype(np.float32)}
    q = pcomp.quantize_blockwise(_t(tree))
    jq = jcomp.quantize_blockwise(_j(tree))
    for k in tree:
        np.testing.assert_array_equal(q[k]["codes"].numpy(),
                                      np.asarray(jq[k]["codes"]))
        np.testing.assert_array_equal(q[k]["scale"].numpy(),
                                      np.asarray(jq[k]["scale"]))
        assert q[k]["n"] == jq[k]["n"]
    back = pcomp.dequantize_blockwise(q)
    jback = jcomp.dequantize_blockwise(jq)
    for k in tree:
        np.testing.assert_array_equal(back[k].numpy(), np.asarray(jback[k]))
        err = np.abs(back[k].numpy() - tree[k])
        assert err.max() <= np.abs(tree[k]).max() / 127.0 + 1e-6
    assert pcomp.compressed_bytes(_t(tree)) == jcomp.compressed_bytes(_j(tree))
    assert pcomp.compressed_bytes(_t(tree)) < sum(v.size for v in tree.values()) * 4


def test_compressed_allreduce_matches_reference_shard_map():
    """The reference's jitted shard_map program on its (1,) mesh and the
    port's on a (1,) mesh of "cpu", for 20 steps, each fed the reference's
    error buffer: the means equal, the new errors within two float32 ulps
    of the largest summand (XLA fuses ``g - codes * scale``, which rounds
    once where eager rounds twice)."""
    from repro.compat import shard_map
    grads = {"w": np.linspace(-1, 1, 256, dtype=np.float32),
             "b": np.random.default_rng(3).normal(size=(7, 3)).astype(np.float32)}
    jall = jcomp.make_compressed_allreduce("i")
    spec = jax.sharding.PartitionSpec()
    jstep = jax.jit(shard_map(lambda g, e: jall(g, e),
                              mesh=jax.make_mesh((1,), ("i",)),
                              in_specs=(spec, spec), out_specs=(spec, spec),
                              check_replication=False))
    pall = pcomp.make_compressed_allreduce(make_mesh((1,), ("i",), ["cpu"]), "i")
    jerr = jcomp.init_error_feedback(_j(grads))
    for _ in range(20):
        pout, perr = pall([_t(grads)], [_map(lambda e: torch.tensor(
            np.asarray(e)), jerr)])
        jout, jerr = jstep(_j(grads), jerr)
        for k in grads:
            np.testing.assert_array_equal(pout[0][k].numpy(), np.asarray(jout[k]))
            np.testing.assert_allclose(perr[0][k].numpy(), np.asarray(jerr[k]),
                                       rtol=0,
                                       atol=np.abs(grads[k]).max() * 2.0 ** -22)


@pytest.mark.parametrize("shards", [1, 4])
def test_compressed_allreduce_error_feedback(shards):
    """Every shard gets the mean of the shards' dequantized summands (each
    shard's codes as the reference's ``_q8`` makes them), and error
    feedback keeps the long-run mean of the compressed means unbiased."""
    rng = np.random.default_rng(4)
    per_shard = [{"w": (np.linspace(-1, 1, 300) * (i + 1)).astype(np.float32),
                  "m": rng.normal(size=(3, 128)).astype(np.float32)}
                 for i in range(shards)]
    mesh = make_mesh((shards,), ("data",), ["cpu"] * shards)
    allreduce = pcomp.make_compressed_allreduce(mesh, "data")
    errs = [pcomp.init_error_feedback(_t(g)) for g in per_shard]
    jerrs = [jcomp.init_error_feedback(_j(g)) for g in per_shard]
    true_mean = {k: np.mean([g[k] for g in per_shard], axis=0)
                 for k in per_shard[0]}
    acc = {k: 0.0 for k in true_mean}
    for _ in range(20):
        outs, errs = allreduce([_t(g) for g in per_shard], errs)
        for k in true_mean:
            deqs = []
            for i, g in enumerate(per_shard):  # the reference's leaf math
                g32 = jnp.asarray(g[k]) + jerrs[i][k]
                flat, n = jopt._pad_flat(g32)
                deq = jopt._dq8(*jopt._q8(flat))[:n].reshape(g[k].shape)
                jerrs[i] = dict(jerrs[i], **{k: g32 - deq})
                deqs.append(np.asarray(deq))
            want = np.sum(deqs, axis=0) / shards
            for out in outs:
                np.testing.assert_allclose(out[k].numpy(), want, rtol=1e-6,
                                           atol=1e-7)
            acc[k] = acc[k] + outs[0][k].numpy()
    for k in true_mean:
        np.testing.assert_allclose(acc[k] / 20, true_mean[k], atol=2e-3 * shards)


# ----------------------------------------------------------- data


@pytest.mark.parametrize("step", [0, 1, 7, 1000])
def test_token_stream_batches_equal_reference(step):
    kw = dict(vocab_size=500, seed=3)
    got = plm.TokenStream(**kw).batch(6, 12, step)
    want = jlm.TokenStream(**kw).batch(6, 12, step)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_host_shard_iterator_equals_reference():
    kw = dict(global_batch=8, seq_len=4, host_id=1, n_hosts=4, start_step=2,
              skip_steps={3})
    pit = plm.host_shard_iterator(plm.TokenStream(vocab_size=50), **kw)
    jit_ = jlm.host_shard_iterator(jlm.TokenStream(vocab_size=50), **kw)
    for _ in range(3):
        got, want = next(pit), next(jit_)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


# ----------------------------------------------------------- supervisor


class ToyJob(TrainJob):
    """Deterministic counter job: state converges iff replay is exact."""

    def __init__(self, injector: FailureInjector, mesh_scale: float = 1.0):
        self.injector = injector
        self.mesh_scale = mesh_scale
        self.state = {"x": torch.zeros(()), "step": 0}

    def run_step(self, step):
        self.injector.check(step)
        # x_{t+1} = x_t + f(t): any skipped/duplicated step changes the sum
        self.state = {"x": self.state["x"] + (step + 1) ** 2, "step": step + 1}
        return {"x": float(self.state["x"])}

    def save_state(self, store, step):
        store.save({"x": self.state["x"]}, step)

    def load_state(self, store):
        step = store.latest_step()
        if step is None:
            self.state = {"x": torch.zeros(()), "step": 0}
            return None
        restored, _ = store.restore({"x": self.state["x"]})
        self.state = {"x": restored["x"], "step": step}
        return step

    def remesh(self, scale):
        return ToyJob(self.injector, self.mesh_scale * scale)


def expected_sum(n):
    return sum((s + 1) ** 2 for s in range(n))


def test_supervisor_completes_without_failures(tmp_path):
    job = ToyJob(FailureInjector())
    sup = Supervisor(job, CheckpointStore(str(tmp_path)), total_steps=20,
                     checkpoint_every=5)
    out = sup.run()
    assert out["final_step"] == 20
    assert float(job.state["x"]) == expected_sum(20)


def test_supervisor_recovers_from_failures(tmp_path):
    events = []
    job = ToyJob(FailureInjector(fail_at=[7, 13]))
    sup = Supervisor(job, CheckpointStore(str(tmp_path)), total_steps=20,
                     checkpoint_every=5, on_event=lambda k, i: events.append(k))
    out = sup.run()
    assert out["final_step"] == 20 and out["n_retries"] == 2
    assert float(job.state["x"]) == expected_sum(20)
    assert "failure" in events and "restart" in events


def test_supervisor_elastic_remesh(tmp_path):
    """Two consecutive failures trigger a re-mesh onto half the devices."""

    class FlakyJob(ToyJob):
        def run_step(self, step):
            if self.mesh_scale == 1.0 and step >= 6:
                raise NodeFailure("device stays dead at full mesh")
            return super().run_step(step)

    events = []
    sup = Supervisor(FlakyJob(FailureInjector(fail_at=[6])),
                     CheckpointStore(str(tmp_path)), total_steps=12,
                     checkpoint_every=3, elastic_after=2,
                     on_event=lambda k, i: events.append(k))
    out = sup.run()
    assert out["final_step"] == 12 and "elastic_remesh" in events
    assert sup.job.mesh_scale == 0.5
    assert float(sup.job.state["x"]) == expected_sum(12)


def test_supervisor_gives_up_after_max_retries(tmp_path):
    class AlwaysFail(ToyJob):
        def run_step(self, step):
            raise NodeFailure("dead")

    sup = Supervisor(AlwaysFail(FailureInjector()), CheckpointStore(str(tmp_path)),
                     total_steps=5, max_retries=3, elastic_after=99)
    with pytest.raises(RuntimeError, match="exceeded 3 retries"):
        sup.run()


def test_straggler_monitor_flags_slow_host():
    mon = StragglerMonitor(n_hosts=4, deadline_factor=2.0, persistent_limit=3)
    for _ in range(3):
        assert mon.observe([1.0, 1.0, 1.0, 5.0]) == [3]
    assert mon.persistent_stragglers() == [3]
    mon.observe([1.0, 1.0, 1.0, 1.0])  # recovery clears strikes
    assert mon.persistent_stragglers() == []


def test_straggler_skip_rescales_loss():
    """A skipped host's shard carries labels=-100 everywhere => zero weight."""
    it = plm.host_shard_iterator(plm.TokenStream(vocab_size=50), global_batch=8,
                                 seq_len=4, host_id=1, n_hosts=4, skip_steps={1})
    b0, b1 = next(it), next(it)
    assert not b0.get("skipped", False)
    assert b1["skipped"] and (b1["labels"] == -100).all()


# ----------------------------------------------------------- registry, CLI


def test_registry_lists_every_reference_arch():
    assert preg.list_archs() == jreg.list_archs()
    assert preg.ASSIGNED == jreg.ASSIGNED
    for arch in jreg.list_archs():
        assert preg.family(arch) == jreg._MODULES[arch][1]
    e = preg.get_arch("thistle-sbert")
    assert e.family == "encoder"
    assert dataclasses.asdict(e.full) == dataclasses.asdict(
        jreg.get_arch("thistle-sbert").full)
    assert preg.get_config("thistle-sbert", smoke=True).n_layers == 2
    with pytest.raises(KeyError, match="unknown arch"):
        preg.get_arch("bert-large")


@pytest.mark.parametrize("arch,item", [("stablelm-1.6b", "item 9"),
                                       ("graphsage-reddit", "item 9"),
                                       ("fm", "item 9")])
def test_unported_families_name_their_item(arch, item):
    """The lm, gnn and recsys families, which once raised here naming
    ROADMAP.md's item 9, now resolve and train: the CLI's job takes two
    steps on the CPU with a finite, positive loss."""
    from repro_torch.launch.train import ArchJob
    assert preg.get_arch(arch).family == jreg.get_arch(arch).family
    job = ArchJob(arch, full=False, batch=4, seq_len=8, lr=1e-3,
                  total_steps=2, device="cpu")
    job.log_every = 0
    losses = [job.run_step(s)["loss"] for s in range(2)]
    assert all(np.isfinite(x) and x > 0 for x in losses), (item, losses)


def _env():
    return dict(os.environ, PYTHONPATH=str(REPO / "src"))


def test_cli_trains_through_a_failure(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "thistle-sbert", "--device", "cpu", "--steps", "8", "--batch", "4",
         "--seq-len", "16", "--checkpoint-every", "3", "--fail-at", "5",
         "--ckpt-dir", str(tmp_path)],
        env=_env(), cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "[supervisor] failure: {'step': 5" in out.stdout
    assert "[supervisor] restart: {'step': 3}" in out.stdout
    assert "done: 8 steps, 1 restarts" in out.stdout
    assert sorted(os.listdir(tmp_path / "thistle-sbert")) == [
        "step_00000006", "step_00000008"]


@pytest.mark.parametrize("arch", jreg.list_archs())
def test_cli_runs_every_arch_on_the_cpu(arch, tmp_path, capsys):
    """``python -m repro_torch.launch.train --arch <id> --device cpu
    --steps 3`` for every arch id of the registry (the SMOKE configs):
    each family's data, loss and step, the supervisor and checkpoints."""
    from repro_torch.launch.train import main
    assert main(["--arch", arch, "--device", "cpu", "--steps", "3",
                 "--batch", "4", "--seq-len", "16", "--checkpoint-every", "2",
                 "--ckpt-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "done: 3 steps, 0 restarts" in out
    assert sorted(os.listdir(tmp_path / arch)) == ["step_00000002",
                                                    "step_00000003"]


def test_training_modules_load_no_jax():
    code = ("import json, sys, repro_torch.train, repro_torch.train.sbert, "
            "repro_torch.launch.train, repro_torch.ft.supervisor, "
            "repro_torch.data.lm, repro_torch.configs.registry; "
            "print(json.dumps([m for m in sys.modules if m.split('.')[0] "
            "in ('jax', 'jaxlib', 'repro', 'ml_dtypes')]))")
    out = subprocess.run([sys.executable, "-c", code], env=_env(), cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


# ----------------------------------------------------------- attention kernel


def test_flash_attention_refuses_grad_inputs(monkeypatch):
    """On the kernel path (a CUDA tensor; here the dispatch is forced) the
    forward-only kernel refuses inputs that need a gradient, naming why,
    before it builds or launches anything; the plain path differentiates."""
    q = torch.randn(1, 8, 2, 16, requires_grad=True)
    k, v = torch.randn(1, 8, 2, 16), torch.randn(1, 8, 2, 16)
    monkeypatch.setattr(ops, "kernel_path", lambda x, use_kernel=None: True)
    with pytest.raises(ValueError, match="forward only"):
        ops.flash_attention(q, k, v, causal=False)
    with pytest.raises(ValueError, match="gradient"):
        pfa.flash_attention_cuda(k, q, v, causal=False, scale=0.25)
    monkeypatch.undo()
    out = ops.flash_attention(q, k, v, causal=False)
    out.sum().backward()
    assert q.grad is not None and torch.isfinite(q.grad).all()
