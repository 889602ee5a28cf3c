"""The recsys family and its retrieval path in the port against the JAX
package's, on the CPU.

From the reference's seeded parameters (carried across by
``convert.from_reference_params``, lists leaf for leaf) and the same
numpy batches:

  * the four configs (FULL and SMOKE) equal, ``field_vocab_sizes`` and
    ``n_params`` too; the parameter trees leaf for leaf;
  * ``ClickLogs.batch`` and ``sequence_batch`` array for array;
  * ``embedding_bag`` (sum and mean, with a validity mask and an empty bag);
  * each kind's loss, metrics and gradients against
    ``jax.value_and_grad(repro.models.recsys.loss_fn)`` within 1e-5
    (loss relative, each leaf 1e-5 x max|g_ref|);
  * the retrieval towers within 1e-5, and FM's decomposition through the
    port's ``VectorDB("flat", metric="dot")`` at d = embed_dim + 1 (not a
    multiple of 8): the MIPS top item is the argmax of ``fm_forward``
    re-scored over every item;
  * ``VectorDB("flat")`` at d = 11 and 50 (the scan buffer padded to the
    kernel's width) against the reference's ``VectorDB``: ids equal,
    scores within 1e-5, through writes too.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.core import VectorDB as JaxDB  # noqa: E402
from repro.data import clicks as jclicks  # noqa: E402
from repro.models import recsys as jrec  # noqa: E402
from repro_torch import VectorDB  # noqa: E402
from repro_torch.configs import registry as preg  # noqa: E402
from repro_torch.core import convert  # noqa: E402
from repro_torch.data import clicks as pclicks  # noqa: E402
from repro_torch.models import recsys as prec  # noqa: E402
from repro_torch.train import accum as paccum  # noqa: E402
from repro_torch.train import recsys as ptrain  # noqa: E402

KINDS = ["fm", "deepfm", "autoint", "sasrec"]
# jitted at XLA's backend optimization level 0: the same HLO, compiled
# faster
FAST_COMPILE = {"xla_backend_optimization_level": 0}
J_INIT = jax.jit(jrec.init, static_argnums=0, compiler_options=FAST_COMPILE)
J_VG = jax.jit(jax.value_and_grad(jrec.loss_fn, has_aux=True),
               static_argnames=("cfg",), compiler_options=FAST_COMPILE)
_PARAMS = {}


def configs(kind):
    return jreg.get_arch(kind).smoke, preg.get_arch(kind).smoke


def ref_params(kind):
    if kind not in _PARAMS:
        _PARAMS[kind] = jax.tree.map(
            np.asarray, J_INIT(jreg.get_arch(kind).smoke,
                               jax.random.PRNGKey(1)))
    return _PARAMS[kind]


def port_model(kind):
    """The port's model holding the reference's parameters."""
    pc = preg.get_arch(kind).smoke
    model = prec.init(pc, torch.Generator().manual_seed(0), "cpu",
                      trainable=True)
    model.load_state_dict(convert.from_reference_params(ref_params(kind), pc),
                          strict=True)
    return model


def batch_of(kind, n=32, step=0):
    cfg = jreg.get_arch(kind).smoke
    logs = jclicks.ClickLogs(cfg)
    return logs.sequence_batch(n, step) if kind == "sasrec" else \
        logs.batch(n, step)


def pt(batch):
    return {k: torch.tensor(v) for k, v in batch.items()}


def jx(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def close(got, want, tol=1e-5, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


@pytest.mark.parametrize("which", ["full", "smoke"])
@pytest.mark.parametrize("kind", KINDS)
def test_configs_equal_the_reference(kind, which):
    got = getattr(preg.get_arch(kind), which)
    want = getattr(jreg.get_arch(kind), which)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.field_vocab_sizes() == want.field_vocab_sizes()
    assert got.n_params() == want.n_params()
    assert preg.get_arch(kind).family == "recsys"


@pytest.mark.parametrize("kind", KINDS)
def test_parameter_trees_cross_leaf_for_leaf(kind):
    """The port's own init has the reference's leaves (shape, dtype), and
    a reference tree comes back array for array through the port."""
    pc = preg.get_arch(kind).smoke
    own = prec.init(pc, torch.Generator().manual_seed(0), "cpu")
    tree = convert.stack_layers(own.state_dict(), pc)
    got = {jax.tree_util.keystr(k): (tuple(v.shape), str(v.dtype)[6:])
           for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
    want = {jax.tree_util.keystr(k): (tuple(v.shape), str(v.dtype))
            for k, v in jax.tree_util.tree_flatten_with_path(
                ref_params(kind))[0]}
    assert got == want
    back = convert.stack_layers(port_model(kind).state_dict(), pc)
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            ref_params(kind))[0]:
        np.testing.assert_array_equal(flat_b[path].numpy(), leaf)


@pytest.mark.parametrize("step", [0, 5])
@pytest.mark.parametrize("kind", KINDS)
def test_click_logs_equal_the_reference(kind, step):
    for which in ("smoke", "full"):
        jc = getattr(jreg.get_arch(kind), which)
        pc = getattr(preg.get_arch(kind), which)
        jl, pl = jclicks.ClickLogs(jc), pclicks.ClickLogs(pc)
        fn = "sequence_batch" if kind == "sasrec" else "batch"
        want, got = getattr(jl, fn)(64, step), getattr(pl, fn)(64, step)
        assert set(got) == set(want)
        for key in want:
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    np.testing.assert_array_equal(prec.field_offsets(pc),
                                  jrec.field_offsets(jc))


@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("masked", [False, True])
def test_embedding_bag_matches_reference(mode, masked):
    rng = np.random.default_rng(3)
    table = rng.normal(size=(50, 6)).astype(np.float32)
    idx = rng.integers(0, 50, size=40).astype(np.int32)
    bags = rng.integers(0, 9, size=40).astype(np.int32)  # bag 9 stays empty
    valid = rng.random(40) < 0.7 if masked else None
    want = jrec.embedding_bag(jnp.asarray(table), jnp.asarray(idx),
                              jnp.asarray(bags), 10, mode=mode,
                              valid=None if valid is None else
                              jnp.asarray(valid))
    got = prec.embedding_bag(torch.tensor(table), torch.tensor(idx),
                             torch.tensor(bags), 10, mode=mode,
                             valid=None if valid is None else
                             torch.tensor(valid))
    close(got, want, what=mode)
    assert not torch.any(got[9])


@pytest.mark.parametrize("kind", KINDS)
def test_loss_and_grads_match_reference(kind):
    jc, pc = configs(kind)
    batch = batch_of(kind, n=48, step=2)
    (jl, jm), jg = J_VG(jax.tree.map(jnp.asarray, ref_params(kind)), cfg=jc,
                        batch=jx(batch))
    want = convert.from_reference_params(jax.tree.map(np.asarray, jg), pc)
    (loss, metrics), grads = paccum.value_and_grad(
        lambda m, b: prec.loss_fn(m, pc, b), port_model(kind), pt(batch))
    assert float(loss) == pytest.approx(float(jl), rel=1e-5)
    assert set(metrics) == set(jm)
    for name in jm:
        assert float(metrics[name]) == pytest.approx(float(jm[name]),
                                                     rel=1e-5), name
    assert set(grads) == set(want)
    for name, g in grads.items():
        w = want[name].numpy()
        scale = np.abs(w).max()
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-5 * scale + 1e-12, err_msg=name)


def test_forward_logits_match_reference():
    """fm, deepfm and autoint logits, and SASRec's hidden states."""
    for kind in ("fm", "deepfm", "autoint"):
        jc, pc = configs(kind)
        batch = batch_of(kind)
        close(prec.forward(port_model(kind), pc, pt(batch)),
              jrec.forward(ref_params(kind), jc, jx(batch)), what=kind)
    jc, pc = configs("sasrec")
    seq = batch_of("sasrec")["seq"]
    close(prec.sasrec_hidden(port_model("sasrec"), pc, torch.tensor(seq)),
          jrec.sasrec_hidden(ref_params("sasrec"), jc, jnp.asarray(seq)))


@pytest.mark.parametrize("kind", KINDS)
def test_retrieval_towers_match_reference(kind):
    jc, pc = configs(kind)
    model = port_model(kind)
    batch = batch_of(kind, n=8, step=9)
    jp = ref_params(kind)
    if kind == "sasrec":
        close(ptrain.item_vectors(model, pc),
              jrec.sasrec_item_vectors(jp))
        close(ptrain.user_vectors(model, pc, pt(batch)),
              jrec.sasrec_user_vector(jp, jc, jnp.asarray(batch["seq"])))
        return
    n = ptrain.n_items(pc)
    item = (jrec.autoint_item_vectors if kind == "autoint"
            else jrec.fm_item_vectors)
    user = (jrec.autoint_user_vector if kind == "autoint"
            else jrec.fm_user_vector)
    close(ptrain.item_vectors(model, pc, chunk=100),
          item(jp, jc, jnp.arange(n), 0))
    close(ptrain.user_vectors(model, pc, pt(batch)), user(jp, jc, jx(batch), 0))


def test_fm_decomposition_through_the_port_vectordb():
    """FM's item tower in ``VectorDB("flat", metric="dot")`` (d = 9): each
    user's MIPS top item is the argmax of the full model re-scored over
    every item, and the MIPS score plus the user's constant is that
    model score; the answers equal the reference's VectorDB on the same
    vectors."""
    jc, pc = configs("fm")
    model = port_model("fm")
    with torch.no_grad():  # a trained-like model: nonzero dense weights
        model.dense.w.copy_(torch.linspace(-0.2, 0.2, pc.n_dense))
        model.bias.fill_(0.1)
    batch = pt(batch_of("fm", n=8, step=11))
    db = ptrain.retrieval_db(model, pc)
    assert db.index.corpus.shape[1] == pc.embed_dim + 1 == 9
    users = ptrain.user_vectors(model, pc, batch)
    s, ids = db.query(users, k=5)
    full = ptrain.fm_rescore(model, pc, batch, chunk=150)
    assert full.shape == (8, ptrain.n_items(pc))
    top = full.max(dim=1).values
    picked = full[torch.arange(8), ids[:, 0].long()]
    torch.testing.assert_close(picked, top, rtol=1e-5, atol=1e-5)
    const = full[:, 0] - users @ ptrain.item_vectors(model, pc)[0]
    torch.testing.assert_close(s[:, 0] + const, top, rtol=1e-5, atol=1e-5)
    jdb = JaxDB("flat", metric="dot").load(
        np.asarray(ptrain.item_vectors(model, pc)))
    js, ji = jdb.query(users.numpy(), k=5)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ji))
    close(s, js)


def test_trained_fm_serves_through_flat():
    """The retrieval path end to end at SMOKE: the trainer CLI's job lowers
    the loss, then the trained towers serve through the flat engine and
    the MIPS top item is the full model's argmax."""
    from repro_torch.launch.train import ArchJob
    pc = preg.get_arch("fm").smoke
    job = ArchJob("fm", full=False, batch=256, seq_len=0, lr=3e-3,
                  total_steps=40, device="cpu")
    job.log_every = 0
    losses = [job.run_step(s)["loss"] for s in range(40)]
    assert np.mean(losses[-5:]) < np.mean(losses[:5])
    batch = pt(pclicks.ClickLogs(pc).batch(4, step=99))
    s, ids = ptrain.retrieval_db(job.model, pc).query(
        ptrain.user_vectors(job.model, pc, batch), k=3)
    full = ptrain.fm_rescore(job.model, pc, batch)
    assert torch.equal(ids[:, 0].long(), full.argmax(dim=1))


@pytest.mark.parametrize("metric", ["dot", "cosine", "l2"])
@pytest.mark.parametrize("d", [11, 50])
def test_flat_at_a_width_off_the_kernel_multiple(d, metric):
    """``VectorDB("flat")`` at d = 11 and 50 against the reference's: the
    scan buffer is padded with zero columns once (``corpus`` stays the
    (N, d) rows), queries a batch at a time; inserts, deletes and
    upserts keep the padding; a snapshot state holds the unpadded rows."""
    rng = np.random.default_rng(d)
    x = rng.normal(size=(300, d)).astype(np.float32)
    q = rng.normal(size=(7, d)).astype(np.float32)
    db = VectorDB("flat", metric=metric, device="cpu").load(x)
    jdb = JaxDB("flat", metric=metric).load(x)
    assert tuple(db.index.corpus.shape) == (300, d)
    assert db.index._scan.shape[1] % 8 == 0
    for _ in range(2):
        s, i = db.query(q, k=10)
        js, ji = jdb.query(q, k=10)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
        np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-5,
                                   atol=1e-5)
        new = rng.normal(size=(20, d)).astype(np.float32)
        db.insert(new)
        jdb.insert(new)
        db.delete([3, 5])
        jdb.delete([3, 5])
        db.upsert(new[:2], [7, 8])
        jdb.upsert(new[:2], [7, 8])
    assert tuple(db.index.state_dict()["corpus"].shape) == (340, d)


@pytest.mark.parametrize("engine", ["int8", "graph"])
def test_int8_and_graph_at_a_width_off_the_kernel_multiple(engine):
    """The int8 scan and the graph's entry scan and build pad their own
    kernel inputs: d = 11 answers equal the same engine's at d = 16 with
    five zero columns appended."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(400, 11)).astype(np.float32)
    q = rng.normal(size=(6, 11)).astype(np.float32)
    pad = lambda a: np.concatenate([a, np.zeros((len(a), 5), np.float32)], 1)
    kw = dict(degree=8) if engine == "graph" else {}
    a = VectorDB(engine, metric="dot", device="cpu", **kw).load(x)
    b = VectorDB(engine, metric="dot", device="cpu", **kw).load(pad(x))
    (sa, ia), (sb, ib) = a.query(q, k=5), b.query(pad(q), k=5)
    np.testing.assert_array_equal(ia.numpy(), ib.numpy())
    np.testing.assert_allclose(sa.numpy(), sb.numpy(), rtol=1e-6, atol=1e-6)
