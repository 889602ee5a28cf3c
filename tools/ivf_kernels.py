#!/usr/bin/env python3
"""Time the three ivf_adc kernels of one tree on one GPU.

    python3 tools/ivf_kernels.py [--src DIR] [--label L] [--seed S]

Makes inputs shaped like chip_smoke.py phase 4's ivf_pq scan on the card
from ``--seed``: 276,307 code blocks of 32 slots (the MS MARCO passage
count, 8,841,823 rows, in blocks; a tenth of the slots -1) of m = 64 codes,
float32 tables over ksub = 256, nprobe = 8 probes of 512 visit steps, each
probe's first r steps on random real blocks (r uniform in 0..422, a mean
of about 211, as phase 4's queries read) and the rest on the all-pad
block, k = 32. At Q = 1, 32, 512 it times the per-query grid and both
grouped grids (qblk 8, schedule built outside the timing) by CUDA events
over whole calls, and each kernel's device microseconds by torch.profiler,
checks that all three agree bit for bit, and prints one JSON object as its
last line.

``--src`` names the ``src/`` directory whose ``repro_torch`` is timed (by
default this checkout's), so that two trees can be compared on one card in
one call, each in its own process: parent, change, change, parent.
"""
from __future__ import annotations

import argparse
import inspect
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
BLOCKS = 8_841_823 // 32 + 1  # the passages in blocks of 32, and the pad block
BLK, M, KSUB, NPROBE, SPP, TOPK = 32, 64, 256, 8, 512, 32
BATCHES = (1, 32, 512)
REPS = 20


def inputs(Q: int, gen, dev):
    """(visit, luts, coarse) of Q queries, as described above."""
    import torch
    pad = BLOCKS - 1
    real = torch.randint(0, 2 * 211 + 1, (Q, NPROBE, 1), generator=gen,
                         device=dev)
    j = torch.arange(SPP, device=dev)[None, None, :]
    blocks = torch.randint(0, pad, (Q, NPROBE, SPP), generator=gen,
                           device=dev)
    visit = torch.where(j < real, blocks, pad).reshape(Q, -1).int()
    luts = torch.randn((Q, M, KSUB), generator=gen, device=dev)
    coarse = torch.randn((Q, NPROBE), generator=gen, device=dev)
    return visit, luts, coarse


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    from chip_smoke import device_us, gpu_ms, same_result
    from repro_torch.kernels import ivf_adc as K
    from repro_torch.kernels import ops
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"{args.label}: {card}, repro_torch from {K.__file__}", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    codes = torch.randint(0, KSUB, (BLOCKS, BLK, M), generator=gen,
                          device=dev, dtype=torch.uint8)
    ids = torch.arange(BLOCKS * BLK, device=dev,
                       dtype=torch.int32).reshape(BLOCKS, BLK)
    ids[torch.rand((BLOCKS, BLK), generator=gen, device=dev) < 0.1] = -1
    ids[-1] = -1
    pad = BLOCKS - 1
    takes_pad = "pad_block" in inspect.signature(K.ivf_adc_cuda).parameters
    out = {"label": args.label, "card": card, "by_q": {}}
    for Q in BATCHES:
        visit, luts, coarse = inputs(Q, gen, dev)
        kw = dict(k=TOPK, steps_per_probe=SPP)
        pq_kw = dict(kw, pad_block=pad) if takes_pad else kw
        sched = ops.build_schedule(visit, qblk=8, pad_block=pad)
        grids = {
            "ivf_adc": lambda: K.ivf_adc_cuda(codes, ids, visit, luts, coarse,
                                              **pq_kw),
            "ivf_adc_blocked": lambda: K.ivf_adc_blocked_cuda(
                codes, ids, visit, sched, luts, coarse, **kw),
            "ivf_adc_run_resident": lambda: K.ivf_adc_run_resident_cuda(
                codes, ids, visit, sched, luts, coarse, **kw)}
        want = ops.normalize_knockouts(*grids["ivf_adc"]())
        row = {"real_steps": int((visit != pad).sum())}
        for name, fn in grids.items():
            if not same_result(ops.normalize_knockouts(*fn()), want):
                raise AssertionError(f"{name} Q={Q} differs from ivf_adc")
            ms, us = gpu_ms(fn, REPS), device_us(fn)
            row[name] = {"ms": ms, "device_us": us}
            print(f"  {args.label} Q={Q} {name}: {ms:.4f} ms; device us by "
                  "kernel: " + ", ".join(f"{n} {u:.1f}" for n, u in us.items()),
                  flush=True)
        out["by_q"][str(Q)] = row
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
