"""The port's sharded programs on four gloo ranks, against the
single-process port and the reference, on the CPU.

One spawn per module: four processes join a gloo group and build a (2, 2)
("data", "model") ``DeviceMesh``; each runs the same script and rank 0
writes what it measured to a JSON file. They hold:

  * ``launch.steps.make_lm_train`` at stablelm-1.6b SMOKE (float32: bf16
    rounds a tensor-parallel partial sum where the whole product sums in
    float32, so only float32 compares elementwise) against the
    single-process step from the same state (``train.gradient_accumulation``,
    clip, ``adamw_update``): the loss within 1e-5, every leaf of the new
    state within 1e-5;
    The same step with ignored labels, and at deepseek-v2-lite SMOKE (MoE
    with capacity drops, MLA), both with ignored labels;
    deepseek-v3 SMOKE with its MTP head (the vocab-parallel cross
    entropy) with ignored labels;
  * the donated train step against the functional one (``donate=False``):
    every leaf bit for bit, each in the caller's own storage;
  * ``make_lm_prefill`` (with and without a sliding window) and
    ``make_lm_decode`` against ``transformer.prefill`` and
    ``decode_step``: logits and caches within 1e-5, the decode with KV
    heads split over "model", with a split head_dim (one KV head) and
    MLA's split latent cache;
  * ``core.distributed.gspmd_flat_search``, ``two_level_search`` on the
    ``DeviceMesh`` and ``models.gnn_partitioned.make_partitioned_loss``
    against the reference's outputs on the same seeded inputs, which a
    subprocess computes with four host devices (as tests/test_distributed.py
    runs it): ids exact, scores within 1e-4, the loss within 1e-4 and the
    accuracy within 1e-6.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
WORLD = 4

REFERENCE = r'''
import sys
import numpy as np
import jax, jax.numpy as jnp
import dataclasses
from repro.configs import get_arch
from repro.core.distributed import gspmd_flat_search, two_level_search
from repro.data import sbm_graph
from repro.models import gnn
from repro.models.gnn_partitioned import make_partitioned_loss, partition_edges

out = sys.argv[1]
mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2),
                         ("data", "model"))
rng = np.random.default_rng(1)
corpus = rng.normal(size=(512, 16)).astype(np.float32)
q = rng.normal(size=(8, 16)).astype(np.float32)
valid = np.arange(512) < 500
with mesh:
    gs_s, gs_i = jax.jit(lambda c, x, v: gspmd_flat_search(
        c, x, mesh=mesh, k=9, metric="dot", valid=v))(
            jnp.asarray(corpus), jnp.asarray(q), jnp.asarray(valid))
tl_s, tl_i = two_level_search(jnp.asarray(corpus), jnp.asarray(q), mesh=mesh,
                              k=9, q_axes=("data",), c_axes=("model",),
                              tile=64, n_valid=500)
cfg = dataclasses.replace(get_arch("graphsage-reddit").smoke, d_in=8,
                          n_classes=4)
N = 64
g = sbm_graph(N, 4, 8, seed=0)
params = gnn.init(cfg, jax.random.PRNGKey(0))
batch0 = {"feats": jnp.asarray(g["feats"]), "edges": jnp.asarray(g["edges"]),
          "labels": jnp.asarray(g["labels"]),
          "label_mask": jnp.asarray(g["label_mask"])}
loss0, m0 = gnn.node_loss(params, cfg, batch0)
edges_p, evalid, cap = partition_edges(g["edges"], N, 2)
loss_fn = make_partitioned_loss(cfg, mesh, ("data",), N)
batch = dict(batch0, edges=jnp.asarray(edges_p),
             edge_valid=jnp.asarray(evalid))
with mesh:
    loss1, m1 = jax.jit(loss_fn)(params, batch)
leaves = {}
for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
    name = ".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
    leaves["param__" + name] = np.asarray(leaf)
np.savez(out, corpus=corpus, q=q, valid=valid, gs_s=np.asarray(gs_s),
         gs_i=np.asarray(gs_i), tl_s=np.asarray(tl_s), tl_i=np.asarray(tl_i),
         feats=g["feats"], edges=g["edges"], labels=g["labels"],
         label_mask=g["label_mask"], edges_p=edges_p, edge_valid=evalid,
         loss0=float(loss0), acc0=float(m0["acc"]), loss1=float(loss1),
         acc1=float(m1["acc"]), **leaves)
'''

WORKER = r'''
import dataclasses, json, sys
import numpy as np
import torch
torch.set_num_threads(1)
import torch.distributed as dist

rank, world, out_dir, ref_path = (int(sys.argv[1]), int(sys.argv[2]),
                                  sys.argv[3], sys.argv[4])
dist.init_process_group("gloo", init_method=f"file://{out_dir}/pg",
                        rank=rank, world_size=world)
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs.registry import get_arch
from repro_torch.core import convert
from repro_torch.core.distributed import gspmd_flat_search, two_level_search
from repro_torch.core.flat import flat_search
from repro_torch.launch import sharding as sh, steps as S
from repro_torch.launch.shapes import Spec
from repro_torch.models import gnn, transformer
from repro_torch.models.gnn_partitioned import make_partitioned_loss
from repro_torch.train import (adamw_init, adamw_update, clip_by_global_norm,
                               cosine_schedule, gradient_accumulation)

mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
res = {}
arch = "stablelm-1.6b"
cfg = dataclasses.replace(get_arch(arch).smoke, dtype="float32")


def maxdiff(a, b):
    return float((a.float() - b.float()).abs().max())


def fresh(cfg, trainable=True, int8=False):
    model = transformer.init(cfg, torch.Generator().manual_seed(0),
                             device="cpu", trainable=trainable)
    tree = convert.bind_reference_layout(model, cfg)
    opt = adamw_init(tree, int8_state=int8)
    opt["step"] = torch.tensor(1000, dtype=torch.int32)  # past lr = 0
    return model, {"params": tree, "opt": opt}


def train_case(cfg, key, int8=False, masked=False):
    """The sharded step against the single-process one. With int8 moments
    the codes may round the other way at a tie: they are held within one
    code, every other leaf within the float32 bound. ``masked``: labels -1
    (ignored) at a share that falls from row 0 to row 7, so that each
    micro-batch's masked mean counts its own valid tokens."""
    tok = torch.randint(0, cfg.vocab_size, (8, 32),
                        generator=torch.Generator().manual_seed(1))
    labels = tok
    if masked:
        u = torch.rand(8, 32, generator=torch.Generator().manual_seed(3))
        share = torch.linspace(0.9, 0.1, 8)[:, None]
        labels = torch.where(u < share, -1, tok)
    batch = {"tokens": tok, "labels": labels}
    model, state = fresh(cfg, int8=int8)
    grads, loss, _ = gradient_accumulation(
        lambda p, b: transformer.loss_fn(p, cfg, b, remat=True), model,
        batch, 2)
    grads, _ = clip_by_global_norm(convert.stack_layers(grads, cfg), 1.0)
    lr = cosine_schedule(state["opt"]["step"], base_lr=3e-4, warmup=2000,
                         total=100_000)
    p_ref, o_ref = adamw_update(grads, state["opt"], state["params"], lr=lr,
                                int8_state=int8)
    _, state2 = fresh(cfg, int8=int8)
    inputs = {"tokens": Spec((8, 32), torch.int32),
              "labels": Spec((8, 32), torch.int32)}
    built = S.make_lm_train(cfg, mesh, arch, inputs,
                            opts={"n_micro": 2, "int8_opt": int8,
                                  "remat": True})
    new, metrics = built.run(state2, batch)
    new = sh.gather(new)
    want = dict(sh.leaves({"params": p_ref, "opt": o_ref}))
    res[key + "_loss"] = [float(loss), float(metrics["loss"].full_tensor())]
    res[key + "_leaves"] = len(want)
    res[key + "_worst"] = max(maxdiff(v, want[n]) for n, v in sh.leaves(new)
                              if not n.endswith("_q"))
    res[key + "_codes"] = max([maxdiff(v, want[n]) for n, v in sh.leaves(new)
                               if n.endswith("_q")] + [0.0])


def prefill_case(cfg, key):
    model, state = fresh(cfg, trainable=False)
    toks = torch.randint(0, cfg.vocab_size, (4, 16),
                         generator=torch.Generator().manual_seed(2))
    logits_ref, cache_ref = transformer.prefill(model, cfg, toks)
    built = S.make_lm_prefill(cfg, mesh, arch, {"tokens": Spec((4, 16),
                                                               torch.int32)})
    logits, cache = built.run(state["params"], toks)
    res[key + "_logits"] = maxdiff(logits.full_tensor(), logits_ref)
    res[key + "_cache"] = max(maxdiff(cache[n].full_tensor(), cache_ref[n])
                              for n in cache_ref)
    return model, state, logits_ref, cache_ref


def decode_case(cfg, key, prefill_key):
    """Prefill (held as ``prefill_key``), then one decode step from the
    prefilled cache, padded to 24 slots, against ``decode_step``."""
    model, state, logits_ref, cache_ref = prefill_case(cfg, prefill_key)
    cache_ref = {n: transformer.pad_slots(c, 24) for n, c in cache_ref.items()}
    cache_in = {n: c.clone() for n, c in cache_ref.items()}
    nxt = logits_ref[:, -1].argmax(-1)[:, None].int()
    d_ref, c_ref = transformer.decode_step(model, cfg, nxt, cache_ref, 16)
    c_specs = {n: Spec(tuple(c.shape), c.dtype) for n, c in cache_in.items()}
    built = S.make_lm_decode(cfg, mesh, arch, {"token": Spec((4, 1),
                                                             torch.int32),
                                               "cache": c_specs})
    d, c = built.run(state["params"], nxt, cache_in, 16)
    res[key + "_logits"] = maxdiff(d.full_tensor(), d_ref)
    res[key + "_cache"] = max(maxdiff(c[n].full_tensor(), c_ref[n])
                              for n in c_ref)
    res[key + "_split"] = [str(c[n].placements) for n in sorted(c)]


def donate_case(cfg, key, int8=False):
    """The donated train step against the functional one (``donate=False``)
    from the same state: every leaf bit for bit, each written into the
    storage the caller's state held."""
    tok = torch.randint(0, cfg.vocab_size, (8, 32),
                        generator=torch.Generator().manual_seed(4))
    batch = {"tokens": tok, "labels": tok}
    inputs = {"tokens": Spec((8, 32), torch.int32),
              "labels": Spec((8, 32), torch.int32)}
    opts = {"n_micro": 2, "int8_opt": int8, "remat": True}
    out = []
    for donate in (False, True):
        built = S.make_lm_train(cfg, mesh, arch, inputs, opts=opts,
                                donate=donate)
        state, b = built.distribute(fresh(cfg, int8=int8)[1], batch)
        before = {n: (t.to_local().data_ptr(), t.full_tensor().clone())
                  for n, t in sh.leaves(state) if hasattr(t, "to_local")}
        new, _ = built.fn(state, b)
        out.append((dict(sh.leaves(new)), before, new is state or
                    new["params"] is state["params"]))
    (func, _, _), (don, before, same_tree) = out
    res[key + "_leaves"] = len(before)
    res[key + "_same_tree"] = bool(same_tree)
    res[key + "_same_storage"] = all(
        don[n].to_local().data_ptr() == ptr for n, (ptr, _) in before.items())
    res[key + "_bit_equal"] = all(
        torch.equal(don[n].to_local(), func[n].to_local()) for n in before)
    res[key + "_moved"] = sum(not torch.equal(don[n].full_tensor(), old)
                              for n, (_, old) in before.items())


train_case(cfg, "train")
# one KV head: each rank's query heads read it from whole k and v
mqa = dataclasses.replace(cfg, n_kv_heads=1)
train_case(mqa, "train_mqa")
# deepseek-v3 SMOKE with its MTP head: both cross entropies vocab-parallel
v3 = dataclasses.replace(get_arch("deepseek-v3-671b").smoke, dtype="float32")
train_case(v3, "train_mtp", masked=True)
donate_case(cfg, "donate")
donate_case(dataclasses.replace(cfg, vocab_size=384, d_model=128),
            "donate_int8", int8=True)
# int8 moments: a 384-wide head's 3 blocks do not split over 2 model
# ranks, nor a 128-wide model's one block over 2 data ranks (the stacked
# w_down, a layer at a time)
train_case(dataclasses.replace(cfg, vocab_size=384, d_model=128), "train_int8",
           int8=True)
# one KV head on 2 model ranks: the cache splits its head_dim
decode_case(mqa, "decode_mqa", "prefill_mqa")
# ignored labels, whose counts differ between the contiguous micro-batches
train_case(cfg, "train_masked", masked=True)
# MoE and MLA (deepseek-v2-lite SMOKE) with capacity drops: which tokens
# share a routing group depends on the micro-batch's rows
moe = dataclasses.replace(get_arch("deepseek-v2-lite-16b").smoke,
                          dtype="float32")
moe = dataclasses.replace(moe, moe=dataclasses.replace(moe.moe,
                                                       capacity_factor=1.0))
train_case(moe, "train_moe", masked=True)
# MLA's latent cache splits its kv_lora (and rope) columns
decode_case(moe, "decode_mla", "prefill_mla")
# a sliding window shorter than the prompt: the cache's ring is rolled
prefill_case(dataclasses.replace(cfg, window=6), "prefill_window")

# ---- prefill and decode against the unsharded port
decode_case(cfg, "decode", "prefill")

# ---- search and the partitioned GNN loss against the reference's outputs
ref = np.load(ref_path)
corpus, q = torch.tensor(ref["corpus"]), torch.tensor(ref["q"])
s, i = gspmd_flat_search(corpus, q, mesh=mesh, k=9, metric="dot",
                         valid=torch.tensor(ref["valid"]))
s, i = s.full_tensor(), i.full_tensor()
res["gspmd_ids"] = bool((i.numpy() == ref["gs_i"]).all())
res["gspmd_scores"] = float(np.abs(s.numpy() - ref["gs_s"]).max())
s, i = two_level_search(corpus, q, mesh=mesh, k=9, q_axes=("data",),
                        c_axes=("model",), n_valid=500)
s, i = s.full_tensor(), i.full_tensor()
res["two_level_ids"] = bool((i.numpy() == ref["tl_i"]).all())
res["two_level_scores"] = float(np.abs(s.numpy() - ref["tl_s"]).max())
fs, fi = flat_search(corpus, q, metric="dot", k=9,
                     valid=torch.arange(512) < 500)
res["two_level_vs_flat"] = bool((fi == i).all())

gcfg = dataclasses.replace(get_arch("graphsage-reddit").smoke, d_in=8,
                           n_classes=4)
gm = gnn.init(gcfg, torch.Generator().manual_seed(0), device="cpu",
              trainable=True)
gm.load_state_dict({k[len("param__"):]: torch.tensor(ref[k])
                    for k in ref.files if k.startswith("param__")})
gb = {k: torch.tensor(ref[k]) for k in ("feats", "labels", "label_mask")}
loss0, m0 = gnn.node_loss(gm, gcfg, dict(gb, edges=torch.tensor(ref["edges"])))
loss_fn = make_partitioned_loss(gcfg, mesh, ("data",), 64)
loss1, m1 = loss_fn(gm, dict(gb, edges=torch.tensor(ref["edges_p"]),
                             edge_valid=torch.tensor(ref["edge_valid"])))
grads = torch.autograd.grad(loss1, list(gm.parameters()))
res["part_loss"] = [float(loss1), float(ref["loss1"]), float(loss0)]
res["part_acc"] = [float(m1["acc"]), float(ref["acc1"]), float(m0["acc"])]
res["part_grads_finite"] = all(bool(torch.isfinite(g).all()) for g in grads)
if rank == 0:
    with open(f"{out_dir}/result.json", "w") as fh:
        json.dump(res, fh)
dist.destroy_process_group()
'''


def _env():
    return dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu",
                XLA_FLAGS="--xla_force_host_platform_device_count=4",
                OMP_NUM_THREADS="1")


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    d = tmp_path_factory.mktemp("sharded")
    ref_path = d / "ref.npz"
    out = subprocess.run([sys.executable, "-c", REFERENCE, str(ref_path)],
                         capture_output=True, text=True, env=_env(),
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    script = d / "worker.py"
    script.write_text(WORKER)
    procs = [subprocess.Popen([sys.executable, str(script), str(r),
                               str(WORLD), str(d), str(ref_path)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=_env())
             for r in range(WORLD)]
    errs = []
    for p in procs:
        _, err = p.communicate(timeout=600)
        if p.returncode:
            errs.append(err[-3000:])
    assert not errs, errs[0]
    return json.loads((d / "result.json").read_text())


@pytest.mark.parametrize("key", ["train", "train_mqa", "train_int8",
                                 "train_masked", "train_moe", "train_mtp"])
def test_sharded_train_step_matches_single_process(results, key):
    """stablelm SMOKE, its one-KV-head variant (the query heads split over
    "model" while k and v stay whole), int8 moments (blocks that straddle
    two ranks, stacked and not, and the flat layout), ignored labels,
    deepseek-v2-lite SMOKE (MoE with capacity drops, MLA) with ignored
    labels, and deepseek-v3 SMOKE with its MTP head (both cross entropies
    vocab-parallel: the logits split over "model") with ignored labels:
    each micro-batch the global batch's contiguous rows, as the
    single-process step takes them."""
    got, want = results[key + "_loss"][1], results[key + "_loss"][0]
    assert abs(got - want) <= 1e-5, results[key + "_loss"]
    assert results[key + "_leaves"] > 50  # params, both moments, a layer each
    assert results[key + "_worst"] <= 1e-5, results[key + "_worst"]
    assert results[key + "_codes"] <= 1, results[key + "_codes"]


@pytest.mark.parametrize("key", ["prefill", "prefill_mqa", "prefill_window",
                                 "prefill_mla"])
def test_sharded_prefill_matches_unsharded(results, key):
    assert results[key + "_logits"] <= 1e-5
    assert results[key + "_cache"] <= 1e-5


def test_sharded_decode_matches_unsharded(results):
    assert results["decode_logits"] <= 1e-5
    assert results["decode_cache"] <= 1e-5


@pytest.mark.parametrize("key,split", [("decode_mqa", "Shard(dim=4)"),
                                       ("decode_mla", "Shard(dim=3)")])
def test_sharded_decode_on_a_split_cache_matches_unsharded(results, key,
                                                           split):
    """One KV head on 2 model ranks (the cache's head_dim split: each rank
    scores over its columns and the scores are all-reduced) and
    deepseek-v2-lite SMOKE (MLA's latent and rope columns split the same
    way): logits and cache within 1e-5 of ``decode_step``, the cache
    split as the case says."""
    assert results[key + "_logits"] <= 1e-5
    assert results[key + "_cache"] <= 1e-5
    assert all(split in pl for pl in results[key + "_split"]), results[
        key + "_split"]


@pytest.mark.parametrize("key", ["donate", "donate_int8"])
def test_donated_train_step_writes_the_state_in_place(results, key):
    """The donated step (``make_lm_train``'s default) against the
    functional one from the same state, float32 and int8 moments: every
    leaf bit-equal, in the storage the caller's state held, and the step
    returns the caller's trees."""
    assert results[key + "_leaves"] > 50
    assert results[key + "_same_tree"]
    assert results[key + "_same_storage"]
    assert results[key + "_bit_equal"]
    assert results[key + "_moved"] > results[key + "_leaves"] // 2


def test_gspmd_flat_search_matches_reference(results):
    assert results["gspmd_ids"]
    assert results["gspmd_scores"] <= 1e-4


def test_mesh_two_level_search_matches_reference(results):
    assert results["two_level_ids"] and results["two_level_vs_flat"]
    assert results["two_level_scores"] <= 1e-4


def test_partitioned_loss_matches_reference(results):
    loss, ref_loss, baseline = results["part_loss"]
    acc, ref_acc, base_acc = results["part_acc"]
    assert abs(loss - ref_loss) <= 1e-4 and abs(loss - baseline) <= 1e-4
    assert abs(acc - ref_acc) <= 1e-6 and abs(acc - base_acc) <= 1e-6
    assert results["part_grads_finite"]
