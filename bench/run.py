"""Run one cell of the benchmark of ``repro_torch`` once, on the card of the
machine it is started on, and print the result as the last line of
standard output.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up makes the collection and the query pool on the card from the seed,
loads the configuration's system (``bench/systems/<system>.py``: the
engine through ``VectorDB.load``) and warms every shape the cell's traffic
uses through the traffic's driver (``bench/drivers/<driver>.py``); the
first run in a checkout also builds the kernels into
``src/repro_torch/_build/``. The window then offers the traffic for
``--seconds``: with ``--trace 0`` the end-to-end metrics are taken, with
``--trace 1`` the per-layer ones, under ``torch.profiler`` for at most
``TRACE_SECONDS``; each metric is read by ``bench/metrics/<metric>.py``.
Once the window has closed, the program is freed and the plain reference
(``bench/reference/``) judges a sample of the window's answers, drawn from
the seed; each number it compares is printed beside its limit, as the last
lines of standard error and under ``checks``, the last key of the result.

Exits 2 without a result when there is no CUDA card or fewer than the cell
asks for, and 3 when JAX or the JAX package was loaded.
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent / "src")]

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
TRACE_SECONDS = 5.0


def log(what: str) -> None:
    """A progress line on standard error, seconds since the start."""
    print(f"bench {time.perf_counter() - T_PROCESS:9.3f} s: {what}",
          file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared
    whole (``repro_torch`` is not ``repro``)."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def card_facts(device) -> dict:
    import torch
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "sms": 0, "mhz": 0.0,
                "power_limit": "none"}
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=power.limit,clocks.max.sm",
         "--format=csv,noheader,nounits", f"--id={device.index or 0}"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    power, mhz = [v.strip() for v in out.strip().splitlines()[0].split(",")]
    props = torch.cuda.get_device_properties(device)
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "sms": props.multi_processor_count, "mhz": float(mhz),
            "power_limit": f"{power} W"}


def sample(rec, n: int, seed: int, k: int):
    """(pool rows, scores (S, k), ids (S, k), missing (S,)) of ``n``
    answers drawn from the seed among those the window kept."""
    import numpy as np
    import torch
    rng = np.random.default_rng([seed, 1])
    pick = rng.choice(len(rec.kept), min(n, len(rec.kept)), replace=False)
    rows, scores, ids, missing = [], [], [], []
    for j in sorted(pick):
        row, s, i = rec.kept[j]
        rows.append(row)
        missing.append(i is None)
        scores.append(np.full(k, -np.inf, np.float32) if s is None else s)
        ids.append(np.full(k, -1, np.int64) if i is None else i)
    return (torch.as_tensor(rows), torch.as_tensor(np.stack(scores)),
            torch.as_tensor(np.stack(ids)).long(), torch.as_tensor(missing))


def run(cell, seed: int, seconds: float, trace: bool, device,
        wrap=None, control: bool = False):
    """One run of ``cell`` (a ``harness.manifest.Cell``): the result dict.
    ``wrap(db)``, for tests, puts a broken entry in the window's place;
    ``control`` also judges the reference's bf16 control in the program's
    place on the same sample, under ``result["control"]``."""
    import numpy as np
    import torch
    from harness import data, manifest, peaks
    from harness import trace as tr

    cfg, traffic, wl = cell.config, cell.traffic, cell.workload
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.set_device(device)
        torch.cuda.reset_peak_memory_stats(device)
    card = card_facts(device)
    log(f"card {card}")
    gen, corpus, held = data.collection(cfg["data"], data.held_rows(traffic),
                                        seed, device)
    print0 = data.fingerprint(corpus)
    pool, _ = data.query_pool(traffic, held, gen)
    del held, gen
    log("collection and pool made")
    system = manifest.system(cfg["system"])
    db = system.build(cfg, corpus, device)
    del corpus
    gc.collect()
    log(f"{cfg['engine']} loaded")
    entry = tr.SpanDB(db) if trace else db
    if wrap is not None:
        entry = wrap(entry)
    driver = manifest.driver(traffic["driver"])(traffic, pool, seed)
    driver.warm(entry)
    if cuda:
        torch.cuda.synchronize(device)
    counters0 = system.counters(db)
    log("warmed up")
    # set-up's objects leave the collector's view: no full collection in
    # the window walks them
    gc.collect()
    gc.freeze()
    profile = tr.Profile() if trace else None
    window_s = min(seconds, TRACE_SECONDS) if trace else seconds
    rec = driver.window(entry, window_s, profile)
    driver.close()
    gc.unfreeze()
    log(f"window closed; {system.describe(db)}; queries/s by 5 s: "
        f"{rec.rates(5.0)}")
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    attempted, failed = rec.attempted, rec.failed

    ref = manifest.reference(cfg["reference"])
    state_names = getattr(ref, "STATE", ())
    state = system.state(db, state_names) if state_names else None
    dev_info = {"platform": card["platform"], "kind": card["kind"],
                "count": 1, "memory_peak_bytes": int(peak),
                "power_limit": card["power_limit"]}
    result = {"correct": False, "attempted": attempted, "failed": failed,
              "metrics": {}, "device": dev_info}
    ctx = SimpleNamespace(cell=cell, rec=rec, seconds=seconds,
                          t_process=T_PROCESS, pool=pool, state=state,
                          card=card, peaks=peaks)
    if trace:
        ctx.trace = profile.summary(getattr(entry, "spans", ()))
        ctx.spans = [s for s in entry.spans if s[0] >= rec.t_start]
        ctx.stats = (counters0, system.counters(db))
        dev_info["busy_s"] = ctx.trace["busy_s"]
        dev_info["window_s"] = ctx.trace["window_s"]
        result["breakdown"] = {
            "device_ops": tr.top(ctx.trace["device_s"]),
            "idle_gaps": tr.top(ctx.trace["idle_gaps"])}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = manifest.metric_reader(m["name"])(ctx)
        if v is not None:
            result["metrics"][m["name"]] = {"value": float(v),
                                            "unit": m["unit"]}
    del ctx

    # the reference, once the window has closed and the program is freed
    k = int(traffic["k"])
    rows, scores, ids, missing = sample(rec, int(wl["sample"]), seed, k)
    queries = pool[rows.to(pool.device)]
    del db, entry, driver, rec, pool
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    log("per-layer metrics read" if trace else "end-to-end metrics taken")
    corpus = data.regenerate(cfg["data"], traffic, seed, device)
    numbers = {"regen_diff": float((data.fingerprint(corpus)
                                    - print0).abs().max()),
               "failed_requests": failed}
    with torch.no_grad():
        own = ref.prepare(corpus, cfg)
        log("reference prepared")
        numbers.update(ref.judge(corpus, queries, scores.to(device),
                                 ids.to(device), missing.to(device), cfg,
                                 state, own))
        if control:
            c_s, c_i, c_state = ref.control(corpus, queries, k, cfg, state,
                                            own)
            result["control"] = ref.judge(corpus, queries, c_s, c_i,
                                          torch.zeros_like(missing).to(device),
                                          cfg, c_state, own)
    log("reference done")
    checks = {n: {"value": v, "limit": wl["limits"][n]}
              for n, v in numbers.items()}
    result["correct"] = all(c["value"] <= c["limit"] and
                            not np.isnan(c["value"]) for c in checks.values())
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from harness import manifest
    cell = manifest.cell(args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " found", file=sys.stderr)
        return 2
    result = run(cell, args.seed, args.seconds, bool(args.trace),
                 torch.device("cuda", 0))
    bad = forbidden_modules()
    if bad:
        print(f"loaded modules of JAX or the JAX package: {bad}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
