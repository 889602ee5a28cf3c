"""The GNN family in the port against the JAX package's, on the CPU.

From the reference's seeded parameters (carried across by
``convert.from_reference_params``, the layer list leaf for leaf) and the
same numpy graphs:

  * the config (FULL and SMOKE) equal; ``sbm_graph`` and
    ``molecule_batch`` array for array;
  * ``node_loss`` (full graph), ``block_loss`` (sampled blocks) and
    ``graph_loss`` (packed molecules) and their gradients against
    ``jax.value_and_grad`` for the mean, max and sum aggregators, with and
    without edge masks: loss within 1e-5 relative, each leaf 1e-5 x
    max|g_ref|; ``_aggregate`` itself (an isolated node's max is 0, an
    all-masked node's -1e30, as in the reference);
  * ``NeighborSampler``'s blocks from one seed equal, padded by
    ``pad_sample`` to ``block_static_shapes``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.data import graphs as jgraphs  # noqa: E402
from repro.models import gnn as jgnn  # noqa: E402
from repro_torch.configs import registry as preg  # noqa: E402
from repro_torch.core import convert  # noqa: E402
from repro_torch.data import graphs as pgraphs  # noqa: E402
from repro_torch.models import gnn as pgnn  # noqa: E402
from repro_torch.train import accum as paccum  # noqa: E402

# the reference's side is jitted at XLA's backend optimization level 0:
# the same HLO, compiled faster than its ops one by one
FAST_COMPILE = {"xla_backend_optimization_level": 0}
AGGS = ["mean", "max", "sum"]
N_NODES, N_CLASSES, D_FEAT = 120, 4, 8


def configs(agg, **over):
    out = []
    for reg in (jreg, preg):
        out.append(dataclasses.replace(reg.get_arch("graphsage-reddit").smoke,
                                       aggregator=agg, **over))
    return tuple(out)


def ref_params(jc):
    return jax.tree.map(np.asarray, jgnn.init(jc, jax.random.PRNGKey(2)))


def port_model(jc, pc):
    model = pgnn.init(pc, torch.Generator().manual_seed(0), "cpu",
                      trainable=True)
    model.load_state_dict(convert.from_reference_params(ref_params(jc), pc),
                          strict=True)
    return model


def to_j(x):
    """x's arrays as jax arrays, its ints (static sizes such as a block's
    ``n_dst``) None: ``with_ints`` puts them back inside a jitted
    function."""
    if isinstance(x, dict):
        return {k: to_j(v) for k, v in x.items()}
    if isinstance(x, list):
        return [to_j(v) for v in x]
    if isinstance(x, (int, np.integer)):
        return None
    return jnp.asarray(x)


def with_ints(x, like):
    """``to_j(like)``'s tree x with like's ints back."""
    if isinstance(like, dict):
        return {k: with_ints(x[k], v) for k, v in like.items()}
    if isinstance(like, list):
        return [with_ints(a, b) for a, b in zip(x, like)]
    if isinstance(like, (int, np.integer)):
        return int(like)
    return x


def to_t(x):
    if isinstance(x, dict):
        return {k: to_t(v) for k, v in x.items()}
    if isinstance(x, list):
        return [to_t(v) for v in x]
    if isinstance(x, (int, np.integer)):
        return int(x)
    return torch.tensor(np.asarray(x))


def compare(jc, pc, jloss, ploss, batch):
    """loss, metrics and gradients of one loss in both packages."""
    jp = jax.tree.map(jnp.asarray, ref_params(jc))
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jloss(p, jc, with_ints(b, batch)), has_aux=True),
        compiler_options=FAST_COMPILE)(jp, to_j(batch))
    want = convert.from_reference_params(jax.tree.map(np.asarray, jg), pc)
    (loss, metrics), grads = paccum.value_and_grad(
        lambda m, b: ploss(m, pc, b), port_model(jc, pc), to_t(batch))
    assert float(loss) == pytest.approx(float(jl), rel=1e-5)
    for name in jm:
        assert float(metrics[name]) == pytest.approx(float(jm[name]),
                                                     rel=1e-5), name
    assert set(grads) == set(want)
    for name, g in grads.items():
        w = want[name].numpy()
        assert np.isfinite(g.numpy()).all(), name
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max() + 1e-12,
                                   err_msg=name)


def graph(edge_mask: bool, seed=0):
    g = jgraphs.sbm_graph(N_NODES, N_CLASSES, D_FEAT, seed=seed)
    if edge_mask:
        rng = np.random.default_rng(seed + 1)
        g["edge_mask"] = rng.random(g["edges"].shape[1]) < 0.8
    return g


@pytest.mark.parametrize("which", ["full", "smoke"])
def test_config_equals_the_reference(which):
    got = getattr(preg.get_arch("graphsage-reddit"), which)
    want = getattr(jreg.get_arch("graphsage-reddit"), which)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.n_params() == want.n_params()
    assert preg.get_arch("graphsage-reddit").family == "gnn"


@pytest.mark.parametrize("seed", [0, 3])
def test_graph_data_equal_the_reference(seed):
    for kw in (dict(), dict(avg_degree=20, p_in_out_ratio=3.0)):
        want = jgraphs.sbm_graph(300, 5, 7, seed=seed, **kw)
        got = pgraphs.sbm_graph(300, 5, 7, seed=seed, **kw)
        for key in want:
            assert got[key].dtype == want[key].dtype
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    want = jgraphs.molecule_batch(16, seed=seed)
    got = pgraphs.molecule_batch(16, seed=seed)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("agg", AGGS)
def test_node_loss_matches_reference(agg, masked):
    jc, pc = configs(agg, d_in=D_FEAT, n_classes=N_CLASSES)
    compare(jc, pc, jgnn.node_loss, pgnn.node_loss, graph(masked))


@pytest.mark.parametrize("agg", AGGS)
def test_block_loss_matches_reference(agg):
    """Sampled blocks (with replacement, so repeated sources tie the max),
    padded to static shapes: the padding's masked edges included."""
    jc, pc = configs(agg, d_in=D_FEAT, n_classes=N_CLASSES)
    g = graph(False)
    fan = list(jc.sample_sizes)
    sampler = jgnn.NeighborSampler(g["edges"], N_NODES, fan, seed=4)
    seeds = np.arange(0, N_NODES, 7)[:12]
    nodes, blocks = sampler.sample(seeds)
    nodes, blocks = jgnn.pad_sample(nodes, blocks, len(seeds), fan)
    batch = {"feats": g["feats"][nodes], "blocks": blocks,
             "labels": g["labels"][seeds]}
    compare(jc, pc, jgnn.block_loss, pgnn.block_loss, batch)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("agg", AGGS)
def test_graph_loss_matches_reference(agg, masked):
    jc, pc = configs(agg, d_in=16, n_classes=2)
    m = jgraphs.molecule_batch(8, seed=5)
    if masked:
        rng = np.random.default_rng(6)
        m["edge_mask"] = rng.random(m["edges"].shape[1]) < 0.7
        m["node_mask"] = rng.random(m["feats"].shape[0]) < 0.9
    compare(jc, pc, jgnn.graph_loss, pgnn.graph_loss, m)


@pytest.mark.parametrize("agg", AGGS)
def test_aggregate_matches_reference_at_the_edges(agg):
    """Node 5 has no edge, node 6 only masked ones."""
    rng = np.random.default_rng(7)
    msgs = rng.normal(size=(30, 4)).astype(np.float32)
    dst = rng.integers(0, 5, size=30).astype(np.int32)
    dst[-3:] = 6
    mask = rng.random(30) < 0.8
    mask[-3:] = False
    for m in (None, mask):
        want = jgnn._aggregate(jnp.asarray(msgs), jnp.asarray(dst), 8, agg,
                               None if m is None else jnp.asarray(m))
        got = pgnn._aggregate(torch.tensor(msgs), torch.tensor(dst), 8, agg,
                              None if m is None else torch.tensor(m))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)
        assert not got[5].any()


@pytest.mark.parametrize("seed", [0, 9])
def test_neighbor_sampler_blocks_equal_the_reference(seed):
    g = graph(False, seed=seed)
    fan = [5, 3]
    js = jgnn.NeighborSampler(g["edges"], N_NODES, fan, seed=seed)
    ps = pgnn.NeighborSampler(g["edges"], N_NODES, fan, seed=seed)
    np.testing.assert_array_equal(ps.indptr, js.indptr)
    np.testing.assert_array_equal(ps.nbr, js.nbr)
    for draw in range(2):
        seeds = np.arange(draw, N_NODES, 11)
        (jn, jb), (pn, pb) = js.sample(seeds), ps.sample(seeds)
        jn, jb = jgnn.pad_sample(jn, jb, len(seeds), fan)
        pn, pb = pgnn.pad_sample(pn, pb, len(seeds), fan)
        np.testing.assert_array_equal(pn, jn)
        for a, b in zip(pb, jb):
            assert set(a) == set(b)
            for key in b:
                np.testing.assert_array_equal(np.asarray(a[key]),
                                              np.asarray(b[key]), err_msg=key)
    assert pgnn.block_static_shapes(64, fan) == jgnn.block_static_shapes(64, fan)
