"""Per-layer cost accounting for the LM cells (port of
``repro.launch.accounting``).

The reference needed this because XLA counts a scanned layer's body once:
it lowers small unrolled variants of each LM cell and extracts the linear
structure

    cost(L_dense, L_moe) = L_dense*P_d + L_moe*P_m + F

from 2-3 reduced-depth builds ((1,1),(1,3),(2,1) for MoE; L=2,4 dense),
with one microbatch. Train cells also trace grads-only twins, which split
the once-per-step optimizer cost O from the per-microbatch fwd/bwd cost:

    step = n_micro * (fwd/bwd per micro) + O + split

where split is the cost of cutting the global batch into its n_micro
contiguous micro-batches (``steps._micro``), traced on its own.

The port's dry run traces eagerly and counts every layer, so no trip count
needs repairing; the decomposition stays for what it tells: the cost of a
dense layer, of an MoE layer, of the fixed part and of the optimizer,
separately, and a full-depth step's cost without tracing 61 layers.
Assumption (checked by a test at SMOKE depth): layers are
sharding-homogeneous, so a layer's cost at depth 2-4 is its cost at 24-61.
Memory is not taken from these traces: the dry run owns it.

Usage: python -m repro_torch.launch.accounting --arch stablelm-1.6b --shape train_4k
       python -m repro_torch.launch.accounting --all
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

from repro_torch.launch.shapes import Spec


def _measure(built, mesh) -> dict:
    from repro_torch.launch.dryrun import trace
    rec = trace(built, mesh)
    coll = rec["collectives"]
    by_axis = {}
    for v in coll.values():
        for a, n in v["by_axis"].items():
            by_axis[a] = by_axis.get(a, 0.0) + float(n)
    return {
        "flops": rec["cost"]["flops"],
        "bytes": rec["cost"]["bytes_accessed"],   # unfused upper bound
        "coll_bytes": float(rec["collective_bytes_total"]),
        "coll_by_kind": {k: float(v["bytes"]) for k, v in coll.items()},
        "coll_by_axis": by_axis,
    }


def _keys(a: dict, b: dict, k: str) -> set:
    return set(a[k]) | set(b[k])


def _lin(c_hi, c_lo, dl):
    return {k: ((c_hi[k] - c_lo[k]) / dl if not isinstance(c_hi[k], dict) else
                {kk: (c_hi[k].get(kk, 0.0) - c_lo[k].get(kk, 0.0)) / dl
                 for kk in _keys(c_hi, c_lo, k)})
            for k in c_hi}


def _axpy(a, x, y=None):
    """a*x (+ y) over the cost dict structure."""
    out = {}
    for k, v in x.items():
        if isinstance(v, dict):
            keys = set(v) | (set(y[k]) if y else set())
            out[k] = {kk: a * v.get(kk, 0.0) + (y[k].get(kk, 0.0) if y else 0.0)
                      for kk in keys}
        else:
            out[k] = a * v + (y[k] if y else 0.0)
    return out


def _split(cell, mesh, n_micro) -> dict:
    """The cost of cutting the train cell's global batch into ``n_micro``
    contiguous micro-batches, which the one-micro-batch builds skip."""
    from repro_torch.launch import sharding as shard_lib
    from repro_torch.launch import steps
    split = steps.BuiltStep(
        lambda b: [steps._micro(b, i, n_micro) for i in range(n_micro)],
        (cell.inputs,), (shard_lib.batch_pspecs(cell.inputs, mesh),), None,
        mesh, name="split")
    return _measure(split, mesh)


def _reduced_cfgs(cfg):
    """[(tag, cfg_variant, (n_dense, n_moe))] small depth points."""
    if cfg.moe is None:
        return [("L2", dataclasses.replace(cfg, n_layers=2), (2, 0)),
                ("L4", dataclasses.replace(cfg, n_layers=4), (4, 0))]
    mk = lambda d, m: dataclasses.replace(cfg, n_layers=d + m, first_k_dense=d)
    return [("d1m1", mk(1, 1), (1, 1)),
            ("d1m3", mk(1, 3), (1, 3)),
            ("d2m1", mk(2, 1), (2, 1))]


def _extract(points):
    """points: [((n_d, n_m), cost)] -> (P_dense, P_moe, Fixed)."""
    if len(points) == 2:  # dense arch: (2,0), (4,0)
        (l_a, c_a), (l_b, c_b) = points
        per = _lin(c_b, c_a, l_b[0] - l_a[0])
        fixed = _axpy(-l_a[0], per, c_a)
        zero = _axpy(0.0, per)
        return per, zero, fixed
    by = {l: c for l, c in points}
    p_m = _lin(by[(1, 3)], by[(1, 1)], 2)
    p_d = _lin(by[(2, 1)], by[(1, 1)], 1)
    fixed = _axpy(-1.0, p_d, _axpy(-1.0, p_m, by[(1, 1)]))
    return p_d, p_m, fixed


def _build(cell_cfg, cell, mesh, *, with_opt, n_micro):
    from repro_torch.launch import steps
    cell = dataclasses.replace(cell, cfg=cell_cfg)
    if cell.step == "train":
        opts = dict(steps.train_options(cell.arch_id, cell.family))
        opts["n_micro"] = 1
        # one production microbatch: shrink the global batch accordingly
        B = cell.inputs["tokens"].shape[0] // n_micro
        inputs = {k: Spec((B,) + s.shape[1:], s.dtype)
                  for k, s in cell.inputs.items()}
        return steps.make_lm_train(cell_cfg, mesh, cell.arch_id, inputs,
                                   family=cell.family, opts=opts,
                                   with_opt=with_opt)
    if cell.step == "decode":  # the cache's layer count follows the depth
        from repro_torch.launch.shapes import lm_inputs
        cell = dataclasses.replace(cell, inputs=lm_inputs(cell_cfg, cell.meta))
    return steps.build_cell_program(cell, mesh)


def account(cell, mesh, *, verbose: bool = False, arch_id: str = "") -> dict:
    """The cell's per-layer, fixed and total costs a rank, extrapolated to
    its config's depth from the reduced-depth traces."""
    from repro_torch.launch import steps
    cfg = cell.cfg
    prod_opts = steps.train_options(cell.arch_id, cell.family)
    n_micro = prod_opts["n_micro"] if cell.step == "train" else 1
    t0 = time.time()
    points_full, points_noopt = [], []
    for tag, cfg_v, lcount in _reduced_cfgs(cfg):
        c = _measure(_build(cfg_v, cell, mesh, with_opt=True,
                            n_micro=n_micro), mesh)
        points_full.append((lcount, c))
        if verbose:
            print(f"  [{arch_id} x {cell.shape_id}] variant {tag}: "
                  f"{c['flops'] / 1e9:.2f} GF/rank, coll "
                  f"{c['coll_bytes'] / 2**20:.1f} MiB ({time.time() - t0:.0f}s)",
                  flush=True)
        if cell.step == "train" and n_micro > 1:
            points_noopt.append((lcount, _measure(
                _build(cfg_v, cell, mesh, with_opt=False, n_micro=n_micro),
                mesh)))

    p_d, p_m, fixed = _extract(points_full)
    n_d, n_m = cfg.n_dense_layers, cfg.n_moe_layers
    full = _axpy(n_d, p_d, _axpy(n_m, p_m, fixed))
    if cell.step == "train" and n_micro > 1:
        pd_n, pm_n, fx_n = _extract(points_noopt)
        fwd = _axpy(n_d, pd_n, _axpy(n_m, pm_n, fx_n))   # grads-only step
        opt = _axpy(-1.0, fwd, full)
        total = _axpy(n_micro, fwd, _axpy(1.0, _split(cell, mesh, n_micro),
                                          opt))
    else:
        total = full
    return {"n_micro": n_micro, "per_dense_layer": p_d, "per_moe_layer": p_m,
            "fixed": fixed, "total": total,
            "seconds": round(time.time() - t0, 1)}


def run_cell(arch_id: str, shape_id: str, mesh=None, verbose=True):
    """One LM cell on the production (16, 16) mesh over the fake group the
    caller set up (``dryrun.fake_world(256)``); None for other families
    (their programs have no layer stacks) and for skipped cells."""
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.shapes import cell_is_skipped, get_cell

    if cell_is_skipped(arch_id, shape_id):
        return None
    cell = get_cell(arch_id, shape_id)
    if cell.family not in ("lm", "encoder"):
        return None
    mesh = mesh if mesh is not None else make_production_mesh()
    rec = dict(account(cell, mesh, verbose=verbose, arch_id=arch_id),
               arch=arch_id, shape=shape_id)
    if verbose:
        t = rec["total"]
        print(f"[{arch_id} x {shape_id}] ACCOUNTED total: "
              f"{t['flops'] / 1e9:.1f} GF/rank, {t['bytes'] / 2**30:.2f} "
              f"GiB/rank, coll {t['coll_bytes'] / 2**20:.1f} MiB/rank  "
              f"({rec['seconds']}s)", flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="experiments/accounting_torch")
    args = ap.parse_args(argv)
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.dryrun import fake_world
    from repro_torch.launch.shapes import all_cells
    cells = (all_cells() if args.all else [(args.arch, args.shape)])
    os.makedirs(args.out, exist_ok=True)
    with fake_world(256):
        for arch_id, shape_id in cells:
            if get_arch(arch_id).family not in ("lm", "encoder"):
                continue
            path = os.path.join(args.out, f"{arch_id}__{shape_id}__pod1.json")
            if os.path.exists(path):
                print(f"[{arch_id} x {shape_id}] cached")
                continue
            try:
                rec = run_cell(arch_id, shape_id)
            except Exception as e:
                import traceback
                traceback.print_exc()
                rec = {"arch": arch_id, "shape": shape_id, "status": "error",
                       "error": str(e)}
            if rec is not None:
                with open(path, "w") as fh:
                    json.dump(rec, fh, indent=1)


if __name__ == "__main__":
    main()
