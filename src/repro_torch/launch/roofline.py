"""Roofline analysis over the dry-run records, against H100 SXM (port of
``repro.launch.roofline``).

Per (arch x shape) cell, from the single-pod dry run (``launch.dryrun``,
whose counts are a rank's: the local ops of rank 0):

  compute term    = FLOPs a rank / peak FLOP/s                  [s]
  memory term     = bytes accessed a rank / HBM bandwidth       [s]
  collective term = sum over mesh axes of a rank's collective
                    bytes on that axis / that axis's bandwidth  [s]

An axis whose ranks share one 8-GPU node (its size times the sizes of the
axes inside it at most 8; ranks are laid out row-major) runs over NVLink,
450 GB/s a direction a GPU; any other over InfiniBand, one 400 Gb/s NIC a
GPU, 50 GB/s. On the (16, 16) and (2, 16, 16) meshes every axis crosses
nodes: a 16-wide "model" axis spans two nodes.

MODEL_FLOPS is the textbook useful-work count (6·N·D train / 2·N_active·D
forward, family-specific below); MODEL/traced is the share of the traced
compute that is "useful": remat recompute, dispatch one-hots and padding
push it below 1. Every number here is derived from shapes against the
H100 SXM data sheet, none is measured.

Usage: python -m repro_torch.launch.roofline [--dryrun-dir DIR]
"""
from __future__ import annotations

import argparse
import glob
import json
import math
import os
from typing import Dict, Optional

PEAK_FLOPS = 989e12      # H100 SXM dense bf16 on the tensor cores
HBM_BW = 3.35e12         # H100 SXM HBM3
NVLINK_BW = 450e9        # NVLink 4, a direction a GPU
IB_BW = 50e9             # 400 Gb/s InfiniBand NDR, one NIC a GPU
GPUS_PER_NODE = 8
HBM_PER_CARD = 80 * 10**9  # H100 80GB


# ------------------------------------------------- model (useful) FLOPs


def model_flops(arch_id: str, shape_id: str) -> Optional[float]:
    """Global useful FLOPs for one step of this cell."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.shapes import FAMILY_SHAPES
    e = get_arch(arch_id)
    shp = FAMILY_SHAPES[e.family][shape_id]
    cfg = e.full
    if e.family in ("lm", "encoder"):
        N_act = cfg.n_active_params()
        B, S = shp["global_batch"], shp["seq_len"]
        if shp["step"] == "train":
            base = 6.0 * N_act * B * S
            # attention scores+context: 12·L·d_head·H·S^2·B fwd+bwd (causal /2)
            attn = 6.0 * 2 * cfg.n_layers * cfg.n_heads * cfg.head_dim * S * S * B / 2
            return base + attn
        if shp["step"] == "prefill":
            base = 2.0 * N_act * B * S
            attn = 2.0 * 2 * cfg.n_layers * cfg.n_heads * cfg.head_dim * S * S * B / 2
            return base + attn
        # decode: one token; attention reads the whole cache
        C = S if cfg.window is None else min(S, cfg.window)
        attn = 2.0 * 2 * cfg.n_layers * cfg.n_heads * cfg.head_dim * C * B
        return 2.0 * N_act * B + attn
    if e.family == "gnn":
        d_h, L = cfg.d_hidden, cfg.n_layers
        if shp["step"] == "train_full":
            N, E = shp["n_nodes"], 2 * shp["n_edges"]
            d_in = shp["d_feat"]
            f = 0.0
            d_prev = d_in
            for _ in range(L):
                f += 2.0 * N * d_prev * d_h * 2 + 2.0 * E * d_prev  # matmuls + agg
                d_prev = d_h
            f += 2.0 * N * d_h * shp["n_classes"]
            return 3.0 * f  # fwd + bwd
        if shp["step"] == "train_blocks":
            from repro_torch.models.gnn import block_static_shapes
            n_in, blocks = block_static_shapes(shp["batch_nodes"], shp["fanout"])
            d_prev = shp["d_feat"]
            f = 0.0
            for b in blocks:
                f += 2.0 * b["n_src"] * d_prev * d_h + 2.0 * b["n_dst"] * d_prev * d_h
                f += 2.0 * b["n_edges"] * d_prev
                d_prev = d_h
            f += 2.0 * shp["batch_nodes"] * d_h * shp["n_classes"]
            return 3.0 * f
        B, n, ed = shp["batch"], shp["n_nodes"], shp["n_edges"]
        d_prev, f = shp["d_feat"], 0.0
        for _ in range(L):
            f += 2.0 * B * n * d_prev * d_h * 2 + 2.0 * B * ed * d_prev
            d_prev = d_h
        f += 2.0 * B * d_h * shp["n_classes"]
        return 3.0 * f
    # recsys
    B = shp["batch"]
    if cfg.kind == "sasrec":
        d, S, L = cfg.embed_dim, cfg.seq_len, cfg.n_blocks
        per_tok = 2.0 * (4 * d * d + 2 * d * d) + 2.0 * 2 * d * S  # proj + attn
        fwd = B * S * per_tok * L
        if shp["step"] == "train":
            return 3.0 * fwd
        if shp["step"] == "retrieval":
            return fwd + 2.0 * B * shp["n_candidates"] * d
        return fwd + 2.0 * B * cfg.n_items * d  # serve scores all items
    F = cfg.n_sparse + cfg.n_dense
    k = cfg.embed_dim
    per = 2.0 * F * k  # embedding sum + fm trick
    if cfg.kind in ("deepfm",):
        dims = (F * k,) + tuple(cfg.mlp_dims) + (1,)
        per += sum(2.0 * a * b for a, b in zip(dims[:-1], dims[1:]))
    if cfg.kind == "autoint":
        da = cfg.d_attn * cfg.n_attn_heads
        d_prev = k
        for _ in range(cfg.n_attn_layers):
            per += 2.0 * F * d_prev * da * 4 + 2.0 * F * F * da * 2
            d_prev = da
    if shp["step"] == "train":
        return 3.0 * B * per
    if shp["step"] == "retrieval":
        q_dim = k + 1 if cfg.kind in ("fm", "deepfm") else cfg.d_attn * cfg.n_attn_heads
        return B * per + 2.0 * B * shp["n_candidates"] * q_dim
    return B * per


# ------------------------------------------------- table


def axis_bandwidth(mesh_shape: Dict[str, int], axis: str) -> float:
    """NVLink when the axis's ranks share a node (row-major layout), else
    InfiniBand."""
    names = list(mesh_shape)
    if axis not in mesh_shape:
        return IB_BW
    inner = math.prod(mesh_shape[a] for a in names[names.index(axis) + 1:])
    return NVLINK_BW if mesh_shape[axis] * inner <= GPUS_PER_NODE else IB_BW


def _coll_by_axis(rec: Dict) -> Dict[str, float]:
    out = {}
    for v in rec["collectives"].values():
        for a, n in v.get("by_axis", {}).items():
            out[a] = out.get(a, 0.0) + float(n)
    return out


def analyze(rec: Dict, acct: Optional[Dict] = None) -> Dict:
    """acct: the per-layer extrapolation from ``launch.accounting``; its
    totals replace the dry run's counts where given."""
    if acct is not None and "total" in acct:
        flops_dev = acct["total"]["flops"]
        bytes_dev = acct["total"]["bytes"]
        by_axis = acct["total"]["coll_by_axis"]
    else:
        flops_dev = rec["cost"]["flops"]
        bytes_dev = rec["cost"]["bytes_accessed"]
        by_axis = _coll_by_axis(rec)
    shape = rec["mesh"]["shape"]
    n_dev = rec["mesh"]["n_devices"]
    t_c = flops_dev / PEAK_FLOPS
    t_m = bytes_dev / HBM_BW
    t_x = sum(n / axis_bandwidth(shape, a) for a, n in by_axis.items())
    dom = max(("compute", t_c), ("memory", t_m), ("collective", t_x),
              key=lambda kv: kv[1])[0]
    mf = model_flops(rec["arch"], rec["shape"])
    useful = (mf / (flops_dev * n_dev)) if (mf and flops_dev) else None
    # roofline fraction: useful work at peak vs the step's bound
    t_bound = max(t_c, t_m, t_x)
    frac = (mf / n_dev / PEAK_FLOPS) / t_bound if (mf and t_bound) else None
    peak_mem = rec["memory"]["peak_bytes"]
    return {
        "arch": rec["arch"], "shape": rec["shape"],
        "compute_s": t_c, "memory_s": t_m, "collective_s": t_x,
        "dominant": dom, "model_flops": mf,
        "useful_ratio": useful, "roofline_fraction": frac,
        "mem_per_dev_gib": peak_mem / 2**30,
        "fits_hbm": peak_mem <= HBM_PER_CARD,
        "accounted": acct is not None,
        "collectives": {k: v for k, v in rec["collectives"].items()
                        if v["count"]},
    }


def fmt_row(a: Dict) -> str:
    def s(x):
        return f"{x * 1e3:9.3f}" if x is not None else "      n/a"
    fr = (f"{a['roofline_fraction'] * 100:5.1f}%"
          if a["roofline_fraction"] else "  n/a")
    ur = f"{a['useful_ratio'] * 100:5.1f}%" if a["useful_ratio"] else "  n/a"
    return (f"| {a['arch']:22s} | {a['shape']:14s} | {s(a['compute_s'])} | "
            f"{s(a['memory_s'])} | {s(a['collective_s'])} | "
            f"{a['dominant']:10s} | {ur} | {fr} | "
            f"{a['mem_per_dev_gib']:6.2f} | "
            f"{'y' if a['fits_hbm'] else 'OVER'} |")


def grid(rows) -> str:
    """The rows as one small table a family: a row an arch, a column a
    shape, each cell "bound ms, dominant term (C compute, M memory, X
    collective), GiB a rank" and OVER where the peak passes the card."""
    from repro_torch.configs.registry import ASSIGNED, get_arch
    from repro_torch.launch.shapes import FAMILY_SHAPES
    by = {(r["arch"], r["shape"]): r for r in rows}

    def cell(r):
        if r is None:
            return "-"
        bound = max(r["compute_s"], r["memory_s"], r["collective_s"]) * 1e3
        dom = {"compute": "C", "memory": "M", "collective": "X"}[r["dominant"]]
        over = "" if r["fits_hbm"] else " OVER"
        return f"{bound:,.1f} {dom}, {r['mem_per_dev_gib']:.1f}{over}"

    out = []
    for fam in ("lm", "gnn", "recsys"):
        archs = [a for a in ASSIGNED if get_arch(a).family == fam]
        shapes = list(FAMILY_SHAPES[fam])
        out.append(f"| {fam} | " + " | ".join(shapes) + " |")
        out.append("|---" * (len(shapes) + 1) + "|")
        for a in archs:
            out.append(f"| {a} | " + " | ".join(cell(by.get((a, sh)))
                                                for sh in shapes) + " |")
        out.append("")
    return "\n".join(out)


HEADER = ("| arch                   | shape          | compute ms | memory ms | "
          "collect ms | dominant   | MODEL/traced | roofline | GiB/rank | "
          "fits 80 GB |\n|---|---|---|---|---|---|---|---|---|---|")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dryrun-dir", default="experiments/dryrun_torch")
    ap.add_argument("--accounting-dir", default="experiments/accounting_torch")
    ap.add_argument("--pod", default="pod1")
    ap.add_argument("--json-out", default="experiments/roofline_torch.json")
    args = ap.parse_args(argv)
    rows = []
    for path in sorted(glob.glob(os.path.join(args.dryrun_dir,
                                              f"*__{args.pod}.json"))):
        with open(path) as fh:
            rec = json.load(fh)
        if rec.get("status") != "ok":
            continue
        acct = None
        apath = os.path.join(args.accounting_dir, os.path.basename(path))
        if os.path.exists(apath):
            with open(apath) as fh:
                acct = json.load(fh)
            if acct.get("status") == "error":
                acct = None
        rows.append(analyze(rec, acct))
    print(HEADER)
    for a in rows:
        print(fmt_row(a))
    print()
    print(grid(rows))
    os.makedirs(os.path.dirname(args.json_out) or ".", exist_ok=True)
    with open(args.json_out, "w") as fh:
        json.dump(rows, fh, indent=1, default=str)


if __name__ == "__main__":
    main()
