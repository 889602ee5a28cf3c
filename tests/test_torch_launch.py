"""The port's launch layer (``repro_torch.launch``: mesh, sharding rules,
cell shapes, step builders, the fake-rank dry run, accounting and the
H100 roofline) against the reference's, on the CPU.

The sharding rules are held leaf by leaf: the port's trees come from
``steps.abstract_state`` (the model built on the ``meta`` device), the
reference's from ``jax.eval_shape``, both in the reference layout, and
both packages' rules run on the same meshes (the reference's on a
``jax.sharding.AbstractMesh``, the port's on a ``launch.mesh.AbstractMesh``:
the rules read axis names and sizes only). Every SMOKE cell's program is
traced once on a fake (2, 4) mesh (``dryrun``), a hand-sharded matmul
reports exactly an eighth of the global FLOPs, the accounting's per-layer
extrapolation equals a direct trace, and the roofline row is recomputed
by hand. The multi-rank numerics are in tests/test_torch_sharded.py.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro_torch.configs.registry import get_arch, list_archs  # noqa: E402
from repro_torch.core.distributed import PartitionSpec  # noqa: E402
from repro_torch.launch import dryrun, roofline  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.launch import shapes as shapes_lib  # noqa: E402
from repro_torch.launch import sharding as sh  # noqa: E402
from repro_torch.launch import steps as steps_lib  # noqa: E402

MESHES = {"2x4": ((2, 4), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
SIZES = ("full", "smoke")


def _norm(spec) -> tuple:
    out = []
    for e in spec:
        out.append(None if e is None else ((e,) if isinstance(e, str)
                                           else tuple(e)))
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _ref_flat(tree) -> dict:
    import jax
    from jax.sharding import PartitionSpec as JP
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): _norm(spec) for path, spec in flat}


def _port_flat(tree) -> dict:
    return {name.replace(".", "/"): _norm(spec)
            for name, spec in sh.leaves(tree)}


def _meshes(name):
    from jax.sharding import AbstractMesh
    shape, names = MESHES[name]
    return AbstractMesh(shape, names), mesh_lib.AbstractMesh(shape, names)


def _cfg(arch, size):
    e = get_arch(arch)
    return e.family, getattr(e, size)


@functools.lru_cache(maxsize=None)
def _ref_state(arch, size, int8):
    from repro.configs import get_arch as ref_arch
    from repro.launch import steps as RS
    e = ref_arch(arch)
    return RS.abstract_state(getattr(e, size), e.family, int8_opt=int8)


@functools.lru_cache(maxsize=None)
def _port_state(arch, size, int8):
    family, cfg = _cfg(arch, size)
    return steps_lib.abstract_state(cfg, family, int8_opt=int8)


# ------------------------------------------------------------ specs


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("arch", list_archs())
def test_param_and_opt_pspecs_equal_reference(arch, size, mesh):
    """param_pspecs (train and serve) and opt_pspecs (float32 and int8
    state: nd and flat layouts) leaf by leaf."""
    from repro.launch import sharding as RSH
    from repro.launch import steps as RS
    r_mesh, p_mesh = _meshes(mesh)
    family = get_arch(arch).family
    for int8 in (False, True):
        ref, port = _ref_state(arch, size, int8), _port_state(arch, size, int8)
        r_specs = RS.state_pspecs(ref, r_mesh, family)
        p_specs = steps_lib.state_pspecs(port, p_mesh, family)
        r, p = _ref_flat(r_specs), _port_flat(p_specs)
        assert set(r) == set(p), (set(r) ^ set(p))
        assert r == p, {k: (r[k], p[k]) for k in r if r[k] != p[k]}
    r = _ref_flat(RSH.param_pspecs(ref["params"], r_mesh, family,
                                   mode="serve"))
    p = _port_flat(sh.param_pspecs(port["params"], p_mesh, family,
                                   mode="serve"))
    assert r == p, {k: (r[k], p[k]) for k in r if r.get(k) != p.get(k)}


@pytest.mark.parametrize("mesh", list(MESHES))
def test_module_specs_take_the_trailing_dims(mesh):
    """A module's unrolled layers take the rule's trailing dims: each
    layer's spec is its stacked leaf's without the layer axis."""
    _, p_mesh = _meshes(mesh)
    cfg = get_arch("deepseek-v2-lite-16b").full
    model = steps_lib.skeleton(cfg, "lm")
    by_name = sh.param_pspecs(model, p_mesh, "lm")
    stacked = _port_flat(sh.param_pspecs(_port_state(
        "deepseek-v2-lite-16b", "full", False)["params"], p_mesh, "lm"))
    for name, spec in by_name.items():
        parts = name.split(".")
        if parts[0] in ("dense_blocks", "moe_blocks", "mtp"):
            want = stacked["/".join([parts[0]] + parts[2:])]
            assert _norm(spec) == want[1:] if want else _norm(spec) == ()
        else:
            assert _norm(spec) == stacked[name.replace(".", "/")]


def _cells():
    return [(a, s) for a, s in shapes_lib.all_cells(include_skipped=True)]


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("size", SIZES)
def test_batch_and_cache_pspecs_equal_reference(size, mesh):
    """batch_pspecs, gnn_batch_pspecs and cache_pspecs over every cell's
    inputs."""
    from repro.launch import sharding as RSH
    from repro.launch.shapes import get_cell as ref_cell
    r_mesh, p_mesh = _meshes(mesh)
    smoke = size == "smoke"
    for arch, shape in _cells():
        rc = ref_cell(arch, shape, smoke=smoke)
        pc = shapes_lib.get_cell(arch, shape, smoke=smoke)
        if rc.family == "gnn":
            pairs = [(RSH.gnn_batch_pspecs(rc.inputs, r_mesh),
                      sh.gnn_batch_pspecs(pc.inputs, p_mesh))]
        elif rc.step == "decode":
            B = rc.inputs["token"].shape[0]
            pairs = [(RSH.batch_pspecs(rc.inputs["token"], r_mesh),
                      sh.batch_pspecs(pc.inputs["token"], p_mesh)),
                     (RSH.cache_pspecs(rc.inputs["cache"], r_mesh, B),
                      sh.cache_pspecs(pc.inputs["cache"], p_mesh, B))]
        else:
            pairs = [(RSH.batch_pspecs(rc.inputs, r_mesh),
                      sh.batch_pspecs(pc.inputs, p_mesh))]
        for r, p in pairs:
            if isinstance(p, PartitionSpec):
                assert _norm(r) == _norm(p), (arch, shape)
            else:
                assert _ref_flat(r) == _port_flat(p), (arch, shape)


def test_placements_split_dims_in_mesh_order():
    """A dim over several axes is Shard(d) on each, in mesh order; an
    off-order spec and a reused axis are refused."""
    from torch.distributed.tensor import Replicate, Shard

    class M:  # what placements reads of a DeviceMesh
        mesh_dim_names = ("pod", "data", "model")

        @staticmethod
        def size(i):
            return (2, 16, 16)[i]

    class One(M):  # a one-rank "pod" axis: the same layout either way
        @staticmethod
        def size(i):
            return (1, 16, 16)[i]
    P = PartitionSpec
    assert sh.placements(P(("pod", "data")), One) == (
        Replicate(), Shard(0), Replicate())
    assert sh.placements(P(("pod", "data"), "model"), M) == (
        Shard(0), Shard(0), Shard(1))
    assert sh.placements(P(None, None), M) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="order"):
        sh.placements(P(("data", "pod")), M)
    with pytest.raises(ValueError, match="twice"):
        sh.placements(P("data", "data"), M)


# ------------------------------------------------------------ shapes


def _asdict(x):
    return {k: v for k, v in dataclasses.asdict(x).items()}


@pytest.mark.parametrize("size", SIZES)
def test_cells_equal_reference(size):
    """all_cells (with and without skips), the skip reasons, and each
    cell's step, config, meta and abstract inputs."""
    from repro.launch import shapes as RSh
    import jax
    assert shapes_lib.all_cells() == RSh.all_cells()
    assert (shapes_lib.all_cells(include_skipped=True)
            == RSh.all_cells(include_skipped=True))
    assert len(shapes_lib.all_cells(include_skipped=True)) == 40
    smoke = size == "smoke"
    for arch, shape in shapes_lib.all_cells(include_skipped=True):
        assert (shapes_lib.cell_is_skipped(arch, shape)
                == RSh.cell_is_skipped(arch, shape))
        rc = RSh.get_cell(arch, shape, smoke=smoke)
        pc = shapes_lib.get_cell(arch, shape, smoke=smoke)
        assert (pc.step, pc.family, pc.meta) == (rc.step, rc.family, rc.meta)
        assert _asdict(pc.cfg) == _asdict(rc.cfg), (arch, shape)
        r = {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in path): (tuple(v.shape), str(v.dtype))
             for path, v in jax.tree_util.tree_flatten_with_path(
                 rc.inputs)[0]}
        p = {name.replace(".", "/"): (v.shape, str(v.dtype).split(".")[-1])
             for name, v in sh.leaves(pc.inputs)}
        assert r == p, (arch, shape)
    assert shapes_lib.pad_up(2708) == RSh.pad_up(2708) == 3072


def test_abstract_state_allocates_nothing():
    """v3 FULL's train state (671 billion parameters, int8 moments) is
    built on the meta device."""
    import jax
    st = _port_state("deepseek-v3-671b", "full", True)
    leaves = [t for _, t in sh.leaves(st) if isinstance(t, torch.Tensor)]
    n = sum(t.numel() for name, t in sh.leaves(st["params"]))
    ref = _ref_state("deepseek-v3-671b", "full", True)
    assert n == sum(int(np.prod(x.shape))
                    for x in jax.tree.leaves(ref["params"]))
    assert n > 671e9
    assert all(t.is_meta for t in leaves if t.ndim), "a leaf was allocated"


# ------------------------------------------------------------ mesh


def test_make_host_mesh_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh_lib.make_host_mesh()


def test_production_mesh_needs_its_world():
    with dryrun.fake_world(8):
        with pytest.raises(RuntimeError, match="256 ranks"):
            mesh_lib.make_production_mesh()
    with dryrun.fake_world(512):
        m = mesh_lib.make_production_mesh(multi_pod=True)
        assert mesh_lib.mesh_shape(m) == {"pod": 2, "data": 16, "model": 16}
        assert mesh_lib.batch_axes(m) == ("pod", "data")
        assert mesh_lib.axis_size(m, ("pod", "data")) == 32


# ------------------------------------------------------------ dry run


@pytest.fixture(scope="module")
def fake24():
    with dryrun.fake_world(8):
        yield dryrun.fake_mesh((2, 4), ("data", "model"))


@pytest.mark.parametrize("arch,shape", shapes_lib.all_cells())
def test_every_smoke_cell_traces_on_a_fake_mesh(fake24, arch, shape):
    rec = dryrun.run_cell(arch, shape, mesh=fake24, smoke=True,
                          verbose=False)
    assert rec["status"] == "ok"
    m = rec["memory"]
    assert m["argument_bytes"] > 0 and m["peak_bytes"] >= m["argument_bytes"]
    assert rec["cost"]["bytes_accessed"] > 0
    assert set(rec["collectives"]) == set(dryrun.COLLECTIVES)
    if get_arch(arch).family in ("lm", "encoder"):
        assert rec["cost"]["flops"] > 0
        assert rec["collective_bytes_total"] > 0


def test_hand_sharded_matmul_counts_an_eighth(fake24):
    """A (64, 128) x (128, 256) product split 2 ways over rows ("data")
    and 4 over columns ("model"): rank 0's local product is exactly the
    global FLOPs / 8, and no collective runs."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Replicate, Shard
    fake = FakeTensorMode()
    with fake:
        a = DTensor.from_local(torch.empty(32, 128), fake24,
                               [Shard(0), Replicate()], run_check=False)
        w = DTensor.from_local(torch.empty(128, 64), fake24,
                               [Replicate(), Shard(1)], run_check=False)
        cost = dryrun.LocalCost(fake, dryrun.group_axes(fake24))
        with cost:
            out = a @ w
    assert out.placements == (Shard(0), Shard(1))
    assert cost.flops * 8 == 2 * 64 * 128 * 256
    assert sum(v["count"] for v in cost.collectives.values()) == 0
    # an all-gather over "model" is counted with its axis and result bytes
    with fake:
        cost = dryrun.LocalCost(fake, dryrun.group_axes(fake24))
        with cost:
            out.redistribute(fake24, [Shard(0), Replicate()])
    assert cost.collectives["all-gather"]["count"] == 1
    assert cost.collectives["all-gather"]["by_axis"] == {
        "model": 32 * 256 * 4}


def test_shard_to_shard_counts_one_all_to_all(fake24):
    """A Shard(0) -> Shard(1) redistribute over "model" is one all-to-all
    of the shard (what a rank receives: its new local shard), as NCCL runs
    it, and no all-gather; the peak holds shards, never the whole."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Replicate, Shard
    fake = FakeTensorMode()
    with fake:
        x = DTensor.from_local(torch.empty(8, 64, 32), fake24,
                               [Replicate(), Shard(0)], run_check=False)
        cost = dryrun.LocalCost(fake, dryrun.group_axes(fake24))
        with cost:
            y = x.redistribute(fake24, [Replicate(), Shard(1)])
    shard = 32 * 16 * 32 * 4
    assert tuple(y.to_local().shape) == (32, 16, 32)
    assert cost.collectives["all-to-all"]["count"] == 1
    assert cost.collectives["all-to-all"]["by_axis"] == {"model": shard}
    assert cost.collectives["all-gather"]["count"] == 0
    assert cost.peak < 4 * shard  # the whole tensor is 4 shards


def test_smoke_train_gathers_no_logits_over_model(fake24):
    """stablelm SMOKE's train step: the cross entropy reduces each rank's
    vocab shard (``transformer._vocab_parallel_nll``), so nothing as large
    as a rank's logits made whole over "model" is all-gathered over it."""
    cell = shapes_lib.get_cell("stablelm-1.6b", "train_4k", smoke=True)
    rec = dryrun.run_cell("stablelm-1.6b", "train_4k", mesh=fake24,
                          smoke=True, verbose=False)
    shp = dryrun.smoke_cell(cell).meta
    logits = (shp["global_batch"] // 2) * shp["seq_len"] * (
        cell.cfg.vocab_size * 4)  # float32, rows split over "data"
    gathered = rec["collectives"]["all-gather"]["by_axis"].get("model", 0)
    assert gathered < logits, (gathered, logits)


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "deepseek-v3-671b"])
def test_smoke_decode_gathers_no_cache(fake24, arch):
    """A decode whose cache splits its head_dim over "model" (danube
    SMOKE's 2 KV heads on 4 ranks) or its latent and rope columns
    (deepseek-v3 SMOKE's MLA cache): each rank scores its own columns and
    the scores are all-reduced; no all-gather runs over "model"."""
    rec = dryrun.run_cell(arch, "decode_32k", mesh=fake24, smoke=True,
                          verbose=False)
    assert rec["collectives"]["all-gather"]["by_axis"].get("model", 0) == 0
    assert rec["collectives"]["all-reduce"]["by_axis"].get("model", 0) > 0


# ------------------------------------------------------------ accounting


@pytest.mark.parametrize("arch,shape,layers", [
    ("stablelm-1.6b", "train_4k", {"n_layers": 3}),
    ("h2o-danube-1.8b", "prefill_32k", {"n_layers": 5}),
    ("deepseek-v2-lite-16b", "decode_32k", {"n_layers": 4,
                                            "first_k_dense": 1})])
def test_accounting_extrapolates_to_the_full_depth(fake24, arch, shape,
                                                   layers):
    """The per-layer decomposition from the reduced-depth traces, taken
    to the config's depth, equals a direct trace at that depth: FLOPs
    (exactly, up to the float sums) and collective bytes. A train step's
    split into n_micro fwd/bwd passes and the optimizer is the
    reference's approximation for what runs once a step: its twin counts
    the loss metrics' scalar reductions once a micro-batch (a float32
    each), the real step once."""
    from repro_torch.launch import accounting
    cell = dryrun.smoke_cell(shapes_lib.get_cell(arch, shape, smoke=True),
                             seq=32, batch=4)
    cell = dataclasses.replace(cell, cfg=dataclasses.replace(cell.cfg,
                                                             **layers))
    acct = accounting.account(cell, fake24)
    n_micro = acct["n_micro"]
    direct = accounting._measure(accounting._build(
        cell.cfg, cell, fake24, with_opt=True, n_micro=1), fake24)
    if cell.step == "train":
        # the production step runs n_micro micro-batches of B / n_micro
        built = steps_lib.make_lm_train(cell.cfg, fake24, arch, cell.inputs,
                                        opts=steps_lib.train_options(
                                            arch, "lm"))
        direct = accounting._measure(built, fake24)
        assert n_micro == 2
    total = acct["total"]
    assert total["flops"] == pytest.approx(direct["flops"], rel=1e-12)
    scalars = 4 * 2 * (n_micro - 1)
    assert abs(total["coll_bytes"] - direct["coll_bytes"]) <= scalars + 1e-6
    assert acct["per_dense_layer"]["flops"] > 0


# ------------------------------------------------------------ roofline


def test_analyze_matches_a_hand_computed_row():
    rec = {"arch": "stablelm-1.6b", "shape": "train_4k",
           "mesh": {"shape": {"data": 16, "model": 16}, "n_devices": 256},
           "memory": {"argument_bytes": 10 * 2**30, "output_bytes": 0,
                      "temp_bytes": 70 * 2**30, "peak_bytes": 80 * 2**30},
           "cost": {"flops": 2.0e15, "bytes_accessed": 6.7e12},
           "collectives": {"all-gather": {"count": 3, "bytes": 4.5e11,
                                          "by_axis": {"model": 2.5e11,
                                                      "data": 2.0e11}}},
           "collective_bytes_total": 4.5e11}
    a = roofline.analyze(rec)
    assert a["compute_s"] == pytest.approx(2.0e15 / 989e12)
    assert a["memory_s"] == pytest.approx(2.0)  # 6.7e12 / 3.35e12
    # both axes cross 8-GPU nodes on (16, 16): 400 Gb/s InfiniBand
    assert a["collective_s"] == pytest.approx(4.5e11 / 50e9)
    assert a["dominant"] == "collective"
    mf = roofline.model_flops("stablelm-1.6b", "train_4k")
    cfg = get_arch("stablelm-1.6b").full
    S, B = 4096, 256
    assert mf == pytest.approx(6.0 * cfg.n_active_params() * B * S
                               + 6.0 * 2 * cfg.n_layers * cfg.n_heads
                               * cfg.head_dim * S * S * B / 2)
    assert a["useful_ratio"] == pytest.approx(mf / (2.0e15 * 256))
    assert a["roofline_fraction"] == pytest.approx(
        (mf / 256 / 989e12) / (4.5e11 / 50e9))
    assert a["mem_per_dev_gib"] == pytest.approx(80.0)
    assert not a["fits_hbm"]  # 80 GiB is more than the card's 80 GB
    # an axis inside one node runs over NVLink
    assert roofline.axis_bandwidth({"data": 2, "model": 4}, "data") == 450e9
    assert roofline.axis_bandwidth({"data": 16, "model": 16}, "model") == 50e9
    row = roofline.fmt_row(a)
    assert "collective" in row and "OVER" in row


def test_a_dtensor_never_reaches_a_kernel_wrapper(fake24):
    """kernel_path refuses a DTensor on any device: kernels run on local
    shards (``to_local``), and a sharded tensor never takes a fallback."""
    from torch.distributed.tensor import DTensor, Replicate
    from repro_torch.kernels import ops
    x = DTensor.from_local(torch.randn(64, 16), fake24,
                           [Replicate(), Replicate()], run_check=False)
    with pytest.raises(ValueError, match="local shard"):
        ops.topk_distance(x, x, k=4)


def test_an_op_without_a_sharding_rule_raises_in_a_step(fake24):
    """An op DTensor has no rule for (``renorm`` in this PyTorch) raises
    inside a step as it does outside one: nothing makes its inputs whole
    behind the model code's back."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    x = DTensor.from_local(torch.randn(4, 8), fake24, [Shard(0), Replicate()],
                           run_check=False)
    with pytest.raises(NotImplementedError, match="sharding strategy"):
        steps_lib.spmd(lambda t: torch.renorm(t, 2, 0, 1.0))(x)


def test_log_sigmoid_runs_on_local_shards(fake24):
    """``layers.log_sigmoid`` (sasrec's loss; DTensor has no rule for it)
    is ``F.logsigmoid`` on each rank's shard, the split kept, with its
    gradient."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.models.layers import log_sigmoid
    local = torch.randn(4, 8, requires_grad=True)
    x = DTensor.from_local(local, fake24, [Shard(0), Replicate()],
                           run_check=False)
    y = steps_lib.spmd(log_sigmoid)(x)
    assert y.placements == x.placements
    assert torch.equal(y.to_local(), torch.nn.functional.logsigmoid(local))
    y.to_local().sum().backward()
    assert torch.allclose(local.grad, torch.sigmoid(-local.detach()))


@pytest.mark.parametrize("r", [0, 1, 3, 7])
def test_roll_slots_is_a_roll_that_keeps_the_split(fake24, r):
    """The window ring's roll (``transformer.roll_slots``) equals
    ``torch.roll`` on the slot axis, and on a cache split over batch and
    heads it runs without a collective and keeps the split."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Shard
    from repro_torch.models.transformer import roll_slots
    c = torch.randn(2, 4, 8, 4, 3)
    assert torch.equal(roll_slots(c, r), torch.roll(c, r, dims=2))
    fake = FakeTensorMode()
    with fake:
        d = DTensor.from_local(torch.empty(2, 2, 8, 1, 3), fake24,
                               [Shard(1), Shard(3)], run_check=False)
        cost = dryrun.LocalCost(fake, dryrun.group_axes(fake24))
        with cost:
            out = steps_lib.spmd(roll_slots)(d, r)
    assert out.placements == (Shard(1), Shard(3))
    assert tuple(out.shape) == (2, 4, 8, 4, 3)
    assert sum(v["count"] for v in cost.collectives.values()) == 0


def test_built_step_places_the_train_state(fake24):
    """A train step's input placements follow its specs: the embedding
    table (vocab over "model", d_model over the FSDP axis "data"), the
    batch over "data"."""
    from torch.distributed.tensor import Replicate, Shard
    cell = dryrun.smoke_cell(shapes_lib.get_cell("stablelm-1.6b", "train_4k",
                                                 smoke=True))
    built = steps_lib.build_cell_program(cell, fake24)
    state_pl, batch_pl = built.in_placements()
    assert state_pl["params"]["embed"]["table"] == (Shard(1), Shard(0))
    assert state_pl["opt"]["mu"]["embed"]["table"]["m"] == (Shard(1),
                                                            Shard(0))
    assert batch_pl["tokens"] == (Shard(0), Replicate())
    assert built.donate_argnums == (0,)
