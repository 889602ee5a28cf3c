"""Training the encoder in the port against the JAX package, on the CPU:
whole steps, train states and supervised runs.

  * three train steps (clip, cosine schedule, AdamW in float32 and int8
    state) from the reference's parameters against the reference's jitted
    step: float32 parameters within 1e-4 x each leaf's largest magnitude,
    int8 ones too but for entries moved by a moment code rounded the
    other way (codes equal in 99.9 %, within 1); ``lm_head`` decayed as
    the reference decays it;
  * a train state saved by either package's ``CheckpointStore`` restored
    by the other, leaf for leaf equal, float32 and int8;
  * the reference-layout binding of the model's parameters;
  * a supervised run with failures replaying bit for bit, the example's
    batches, and a short run that lifts retrieval as
    ``tests/test_system.py`` asserts.
"""
import dataclasses
import importlib.util
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import CheckpointStore as JaxStore  # noqa: E402
from repro.configs import thistle_sbert as jcfg  # noqa: E402
from repro.data import marco as jmarco  # noqa: E402
from repro.models import encoder as jenc  # noqa: E402
from repro.train import optim as jopt  # noqa: E402
from repro_torch import VectorDB  # noqa: E402
from repro_torch.checkpoint import CheckpointStore  # noqa: E402
from repro_torch.configs import thistle_sbert as pcfg  # noqa: E402
from repro_torch.core import convert  # noqa: E402
from repro_torch.data.marco import MarcoLike  # noqa: E402
from repro_torch.ft import FailureInjector, Supervisor  # noqa: E402
from repro_torch.models import encoder as penc  # noqa: E402
from repro_torch.train import accum as paccum  # noqa: E402
from repro_torch.train import optim as popt  # noqa: E402
from repro_torch.train.sbert import EncoderJob, SbertJob, sbert_batches  # noqa: E402
from test_torch_train_encoder import (_batch, _configs, _jx,  # noqa: E402
                                      _port_model, _reference_params)

REPO = Path(__file__).resolve().parent.parent


def _reference_step(jc, lr, total, int8):
    @jax.jit
    def step(state, batch):
        (_, m), grads = jax.value_and_grad(
            lambda p: jenc.contrastive_loss(p, jc, batch), has_aux=True)(
                state["params"])
        grads, _ = jopt.clip_by_global_norm(grads, 1.0)
        lr_t = jopt.cosine_schedule(state["opt"]["step"], base_lr=lr,
                                    warmup=2, total=total)
        params, opt = jopt.adamw_update(grads, state["opt"], state["params"],
                                        lr=lr_t, weight_decay=0.01,
                                        int8_state=int8)
        return {"params": params, "opt": opt}, m
    return step


def _port_job(jc, pc, batches, int8, **kw):
    job = EncoderJob(pc, lambda s: batches[s], lr=3e-3, warmup=2,
                     total_steps=10, int8_state=int8, device="cpu",
                     log_every=0, **kw)
    job.model.load_state_dict(
        convert.from_reference_params(_reference_params(jc), pc), strict=True)
    return job


@pytest.mark.parametrize("int8", [False, True])
def test_train_steps_match_reference(int8):
    """Three whole steps from one state: the port's job (clip, schedule,
    AdamW over the reference's layout) against the reference's jitted step;
    ``lm_head`` (no gradient) only decays, as in the reference."""
    jc, pc = _configs("SMOKE", "float32")
    batches = [_batch(8, 16, pc.vocab_size, seed=10 + s) for s in range(3)]
    state = {"params": jax.tree.map(jnp.asarray, _reference_params(jc))}
    state["opt"] = jopt.adamw_init(state["params"], int8_state=int8)
    step = _reference_step(jc, 3e-3, 10, int8)
    job = _port_job(jc, pc, batches, int8)
    for s in range(3):
        state, jm = step(state, _jx(batches[s]))
        m = job.run_step(s)
        assert m["loss"] == pytest.approx(float(jm["loss"]), rel=1e-4)
    want = convert.to_reference_train_state(job.state, pc)
    ref = jax.tree.map(np.asarray, state)
    lm0 = _reference_params(jc)["lm_head"]["w"]
    np.testing.assert_allclose(want["params"]["lm_head"]["w"],
                               ref["params"]["lm_head"]["w"], rtol=1e-6)
    assert not np.array_equal(ref["params"]["lm_head"]["w"], lm0)  # decayed
    n_close = n_all = 0
    for path, got in popt.tree_paths(want["params"]):
        w = popt.tree_get(ref["params"], path)
        close = np.abs(got - w) <= 1e-4 * np.abs(w).max() + 1e-7
        if not int8:
            assert close.all(), path
        # int8 state: a moment code that rounds the other way (as the
        # optimizer tests allow in 0.01 % of entries) moves its entry by
        # less than a step's update, lr at most, each step
        assert np.abs(got - w).max() <= 3 * 2 * 3e-3, path
        n_close, n_all = n_close + int(close.sum()), n_all + close.size
    assert n_close >= 0.9999 * n_all, (n_close, n_all)
    assert int(want["opt"]["step"]) == int(ref["opt"]["step"]) == 3
    for path, got in popt.tree_paths(want["opt"]["mu"]):
        w = popt.tree_get(ref["opt"]["mu"], path)
        if path[-1] in ("m_q", "v_q"):
            diff = np.abs(got.astype(np.int32) - w.astype(np.int32))
            assert diff.max() <= 1 and (diff == 0).mean() >= 0.999, path


# ----------------------------------------------------------- train states


def _jax_state(jc, int8, steps=1):
    """The reference's state after ``steps`` jitted steps (moments nonzero)."""
    state = {"params": jax.tree.map(jnp.asarray, _reference_params(jc))}
    state["opt"] = jopt.adamw_init(state["params"], int8_state=int8)
    step = _reference_step(jc, 3e-3, 10, int8)
    for s in range(steps):
        state, _ = step(state, _jx(_batch(8, 16, jc.vocab_size, seed=20 + s)))
    return state


def _assert_trees_equal(a, b):
    pa, pb = popt.tree_paths(a), popt.tree_paths(b)
    assert [p for p, _ in pa] == [p for p, _ in pb]
    for (path, x), (_, y) in zip(pa, pb):
        x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        y = y.numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape, path
        np.testing.assert_array_equal(x, y, err_msg=str(path))


@pytest.mark.parametrize("int8", [False, True])
def test_port_train_state_restores_in_the_reference(int8, tmp_path):
    jc, pc = _configs("SMOKE", "float32")
    batches = [_batch(8, 16, pc.vocab_size, seed=30 + s) for s in range(2)]
    job = _port_job(jc, pc, batches, int8)
    for s in range(2):
        job.run_step(s)
    CheckpointStore(str(tmp_path)).save(job.state, 2)
    like = _jax_state(jc, int8, steps=0)
    restored, step = JaxStore(str(tmp_path)).restore(like)
    assert step == 2
    _assert_trees_equal(jax.tree.map(np.asarray, restored),
                        convert.to_reference_train_state(job.state, pc))


@pytest.mark.parametrize("int8", [False, True])
def test_reference_train_state_restores_in_the_port(int8, tmp_path):
    jc, pc = _configs("SMOKE", "float32")
    state = jax.tree.map(np.asarray, _jax_state(jc, int8))
    JaxStore(str(tmp_path)).save(state, 1)
    job = _port_job(jc, pc, [], int8)
    assert job.load_state(CheckpointStore(str(tmp_path))) == 1
    _assert_trees_equal(convert.to_reference_train_state(job.state, pc), state)
    # the model's own parameters were written: encode reads the new values
    sd = convert.from_reference_params(state["params"], pc)
    for name, p in job.model.named_parameters():
        assert torch.equal(p.detach(), sd[name]), name
    # and the in-memory conversion gives the same tree
    _assert_trees_equal(convert.from_reference_train_state(state, pc), state)


def test_train_state_conversion_refuses_another_layer_count():
    jc, pc = _configs("SMOKE", "float32")
    state = jax.tree.map(np.asarray, _jax_state(jc, False, steps=0))
    with pytest.raises(ValueError, match="does not stack 3 layers"):
        convert.from_reference_train_state(state, dataclasses.replace(pc, n_layers=3))


def test_bind_reference_layout_shares_storage():
    jc, pc = _configs("SMOKE", "float32")
    model = _port_model(jc, pc)
    names = [n for n, _ in model.named_parameters()]
    tree = convert.bind_reference_layout(model, pc)
    assert [n for n, _ in model.named_parameters()] == names
    wq = tree["dense_blocks"]["attn"]["wq"]
    assert wq.shape == (2, 64, 4, 16) and not wq.requires_grad
    with torch.no_grad():
        wq[1].fill_(0.5)
        tree["embed"]["table"][3].fill_(2.0)
    assert bool((model.dense_blocks[1].attn.wq == 0.5).all())
    assert model.dense_blocks[1].attn.wq.requires_grad
    assert bool((model.embed.table[3] == 2.0).all())
    _assert_trees_equal(convert.stack_layers(
        {n: p.detach() for n, p in model.named_parameters()}, pc), tree)


# ----------------------------------------------------------- runs


@pytest.mark.parametrize("int8", [False, True])
def test_supervised_restarts_replay_bit_for_bit(int8, tmp_path):
    """Failures at steps 5 and 9 with checkpoints every 4: the supervisor
    restores and replays, and the parameters end bit-equal to an
    uninterrupted run's."""
    cfg = pcfg.SMOKE
    data = MarcoLike(n_passages=200, vocab_size=cfg.vocab_size, noise=0.25,
                     passage_len=24, seed=0)
    kw = dict(lr=3e-3, total_steps=12, device="cpu", log_every=0,
              int8_state=int8)
    plain = SbertJob(cfg, data, 16, **kw)
    for s in range(12):
        plain.run_step(s)
    job = SbertJob(cfg, data, 16, injector=FailureInjector(fail_at=[5, 9]), **kw)
    events = []
    store = CheckpointStore(str(tmp_path), keep=2)
    out = Supervisor(job, store, total_steps=12, checkpoint_every=4,
                     on_event=lambda k, i: events.append((k, i.get("step")))).run()
    store.wait()
    assert out["final_step"] == 12 and out["n_retries"] == 2
    assert ("restart", 4) in events and ("restart", 8) in events
    _assert_trees_equal(convert.to_reference_train_state(job.state, cfg),
                        convert.to_reference_train_state(plain.state, cfg))
    assert [h.step for h in job.saves] == [4, 8, 12]
    assert all(h.done() and h.write_s > 0 for h in job.saves)
    assert store.valid_steps() == [8, 12]


def test_sbert_batches_equal_the_example():
    """The port's per-step batches are examples/train_sbert.py's."""
    spec = importlib.util.spec_from_file_location(
        "train_sbert_example", REPO / "examples" / "train_sbert.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    kw = dict(n_passages=300, vocab_size=1000, noise=0.25, passage_len=24, seed=0)
    jdata, pdata = jmarco.MarcoLike(**kw), MarcoLike(**kw)
    fake = types.SimpleNamespace(data=jdata, batch=16, cfg=jcfg.SMOKE)
    batch_fn = sbert_batches(pdata, 16, 1000)
    for step in (0, 3, 299):
        want = example.SbertJob._batch(fake, step)
        got = batch_fn(step)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], np.asarray(want[k]))


def test_training_lifts_retrieval():
    """tests/test_system.py's mini end-to-end on the port: 60 contrastive
    steps must lift top-1 retrieval by more than 0.1."""
    cfg = pcfg.SMOKE
    data = MarcoLike(n_passages=300, vocab_size=cfg.vocab_size, noise=0.2,
                     passage_len=16, query_len=8, seed=5)
    model = penc.init(cfg, torch.Generator().manual_seed(0), device="cpu",
                      trainable=True)
    params = convert.bind_reference_layout(model, cfg)
    state = popt.adamw_init(params)

    def embed(toks):
        t = torch.tensor(np.asarray(toks)[:, :16] % cfg.vocab_size)
        return penc.encode(model, cfg, t, t != 0)

    def acc():
        db = VectorDB("flat", metric="cosine", device="cpu").load(embed(data.passages))
        qs = np.zeros((300, 16), np.int32)
        qs[:, :8] = data.queries()
        _, ids = db.query(embed(qs), k=1)
        return float((ids[:, 0] == torch.arange(300)).float().mean())

    acc0 = acc()
    rng = np.random.default_rng(0)
    qs_all = data.queries()
    for _ in range(60):
        idx = rng.integers(0, 300, size=32)
        q = np.zeros((32, 16), np.int32)
        q[:, :8] = qs_all[idx]
        p = data.passages[idx][:, :16]
        batch = {"q_tokens": torch.tensor(q % cfg.vocab_size),
                 "q_mask": torch.tensor(q != 0),
                 "p_tokens": torch.tensor(p % cfg.vocab_size),
                 "p_mask": torch.tensor(p != 0)}
        _, grads = paccum.value_and_grad(
            lambda m, b: penc.contrastive_loss(m, cfg, b), model, batch)
        grads, _ = popt.clip_by_global_norm(convert.stack_layers(grads, cfg), 1.0)
        new, state = popt.adamw_update(grads, state, params, lr=2e-3)
        with torch.no_grad():
            for path, leaf in popt.tree_paths(params):
                leaf.copy_(popt.tree_get(new, path))
    acc1 = acc()
    assert acc1 > acc0 + 0.1, (acc0, acc1)
