#!/usr/bin/env python3
"""Where a training step of the thistle-sbert encoder spends its time on
the card (the step of ``chip_smoke.py`` phase 10: B = 64, S = 24,
contrastive loss, clip, cosine schedule, AdamW).

    python3 tools/train_step_profile.py [--steps 20] [--config full|smoke]
                                        [--out train_step.json]

For each mode (deterministic algorithms off; on, as phase 10 runs; on
without ``fill_uninitialized_memory``) it times whole steps (host clock
ending in a synchronize), then the step's parts one by one, each ending in
a synchronize: the batch's upload, the forward (both towers and the
loss), the backward, the layout stack of the gradients, clipping and
AdamW. Then ``torch.profiler`` over a few steps: kernel launches a step,
the device's busy time (the sum of kernels' own device time) against the
step's wall time, and the host ops with the most self CPU time. It needs
one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

SRC = Path(__file__).resolve().parent.parent / "src"


def timed(fn, sync) -> float:
    t0 = time.perf_counter()
    fn()
    sync()
    return time.perf_counter() - t0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--config", choices=("full", "smoke"), default="full")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    if not torch.cuda.is_available():
        print("train_step_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import thistle_sbert
    from repro_torch.core import convert
    from repro_torch.data.marco import MarcoLike
    from repro_torch.models import encoder
    from repro_torch.train.optim import (adamw_update, clip_by_global_norm,
                                         cosine_schedule)
    from repro_torch.train.sbert import SbertJob
    from repro_torch.device import float32_bf16_sums, strict_fp32

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = thistle_sbert.FULL if args.config == "full" else thistle_sbert.SMOKE
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, torch.__version__, torch.version.cuda, flush=True)
    data = MarcoLike(n_passages=2000, vocab_size=cfg.vocab_size, noise=0.25,
                     passage_len=24, seed=0)
    job = SbertJob(cfg, data, 64, total_steps=300, device=dev, log_every=0)
    sync = torch.cuda.synchronize
    out = {"card": smi, "config": cfg.name, "modes": {}}
    step = 0
    for mode in ("deterministic off", "deterministic on",
                 "deterministic on, no fill"):
        torch.use_deterministic_algorithms(mode != "deterministic off")
        torch.utils.deterministic.fill_uninitialized_memory = (
            mode != "deterministic on, no fill")
        for _ in range(3):  # warm-up
            job.run_step(step)
            step += 1
        whole = [timed(lambda: job.run_step(step + i), sync)
                 for i in range(args.steps)]
        step += args.steps
        parts = {k: [] for k in ("upload", "forward", "backward", "stack",
                                 "clip", "adamw")}
        for _ in range(args.steps):
            box = {}

            def upload():
                box["b"] = job.device_batch(step)

            def forward():
                box["loss"] = encoder.contrastive_loss(job.model, cfg,
                                                       box["b"])[0]

            def backward():
                named = list(job.model.named_parameters())
                got = torch.autograd.grad(box["loss"], [p for _, p in named],
                                          allow_unused=True)
                box["g"] = {n: torch.zeros_like(p) if g is None else g
                            for (n, p), g in zip(named, got)}

            def stack():
                box["g"] = convert.stack_layers(box["g"], cfg)

            def clip():
                box["g"], _ = clip_by_global_norm(box["g"], 1.0)

            def adamw():
                lr = cosine_schedule(job.opt["step"], base_lr=3e-4, warmup=20,
                                     total=300)
                new, job.opt = adamw_update(box["g"], job.opt, job.params,
                                            lr=lr)
                job.set_params(new)

            with float32_bf16_sums(), strict_fp32():
                for name, fn in (("upload", upload), ("forward", forward),
                                 ("backward", backward), ("stack", stack),
                                 ("clip", clip), ("adamw", adamw)):
                    parts[name].append(timed(fn, sync))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(3):
                job.run_step(step + i)
            sync()
            wall = (time.perf_counter() - t0) / 3
        step += 3
        device_us = launches = 0
        host = []
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = getattr(e, "self_cuda_time_total", 0)
            if e.device_type == torch.autograd.DeviceType.CUDA:
                device_us += us
                launches += e.count
            else:
                host.append((e.self_cpu_time_total / 3 / 1e3, e.key, e.count // 3))
        host.sort(reverse=True)
        res = {"step_ms_p50": statistics.median(whole) * 1e3,
               "step_ms_min": min(whole) * 1e3,
               "parts_ms_p50": {k: statistics.median(v) * 1e3
                                for k, v in parts.items()},
               "profiled_wall_ms": wall * 1e3,
               "device_busy_ms": device_us / 3 / 1e3,
               "kernels_a_step": launches / 3,
               "host_top_ms": [[round(ms, 3), key, n] for ms, key, n in host[:20]]}
        out["modes"][mode] = res
        print(mode, json.dumps(res, indent=1), flush=True)
    torch.use_deterministic_algorithms(False)
    torch.utils.deterministic.fill_uninitialized_memory = True
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
