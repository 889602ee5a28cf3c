"""Readings that the limits of ``bench/workloads/<cell>.json`` are set from:
for each seed, one set-up and a short window of the cell at its own load,
then the numbers the comparison gives the program's answers (the lower
reading) and the bf16 control's in the program's place on the same sample
(the upper reading). Not part of a benchmark run.

    python3 bench/control.py --workload <cell> --seeds 1,2,3 --seconds 3 \
        [--controls 3]

The control runs on the first ``--controls`` seeds (all by default).
Prints one JSON line a seed: {"seed", "correct", "program", "control"}.
"""
from __future__ import annotations

import argparse
import json
import sys

import run as bench_run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--controls", type=int, default=None)
    args = ap.parse_args(argv)
    import torch
    from harness import manifest
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    cell = manifest.cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    controls = len(seeds) if args.controls is None else args.controls
    for j, seed in enumerate(seeds):
        res = bench_run.run(cell, seed, args.seconds, False,
                            torch.device("cuda", 0), control=j < controls)
        print(json.dumps({"seed": seed, "correct": res["correct"],
                          "program": {n: c["value"] for n, c
                                      in res["checks"].items()},
                          "control": res.get("control")}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
