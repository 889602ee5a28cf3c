"""``BENCHMARK.json`` and the files its names resolve to.

A cell ``<config>.<traffic>`` of the manifest's ``workloads`` reads:

* the configuration's ``file`` (``bench/configs/<config>.json``): the
  collection, the system that serves it (``bench/systems/<system>.py``),
  the engine and its arguments, the guarantee, and the plain reference
  that judges it (``bench/reference/<reference>.py``);
* ``bench/traffic/<traffic>.json``: the driver
  (``bench/drivers/<driver>.py``) and its parameters;
* ``bench/workloads/<cell>.json``: the sample the reference judges and the
  limit of each number it compares;
* ``bench/metrics/<metric>.py`` for each metric of the cell, end to end or
  per layer: a ``read(ctx)`` that returns the value or None.

A later cell or metric is files and manifest entries; nothing here changes.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "bench"


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    workload: dict
    end_to_end: list   # the manifest's metric entries this cell reports
    per_layer: list


def load_manifest(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, root: Path = ROOT) -> Cell:
    """The cell's entry and everything it names; KeyError for a name the
    manifest does not hold."""
    man = load_manifest(root)
    entry = next((w for w in man["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                       f"{[w['name'] for w in man['workloads']]}")
    conf = next(c for c in man["configs"] if c["name"] == entry["config"])
    e2e = [m for m in man["end_to_end"] if _applies(m, name)]
    reported = {m["name"] for m in e2e}
    layer = [m for m in man["per_layer"]
             if (name in m["workloads"] if "workloads" in m
                 else m["moves"] in reported)]
    return Cell(name=name, chips=int(entry["chips"]),
                config=_json(root / conf["file"]),
                traffic=_json(root / "bench" / "traffic"
                              / f"{entry['traffic']}.json"),
                workload=_json(root / "bench" / "workloads" / f"{name}.json"),
                end_to_end=e2e, per_layer=layer)


def _module(path: Path, label: str):
    spec = importlib.util.spec_from_file_location(label, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, root: Path = ROOT):
    """``read`` of ``bench/metrics/<name>.py``."""
    return _module(root / "bench" / "metrics" / f"{name}.py",
                   "bench_metric_" + name.replace(".", "_")).read


def driver(name: str):
    """The ``Driver`` class of ``bench/drivers/<name>.py``."""
    return importlib.import_module(f"drivers.{name}").Driver


def system(name: str):
    """The module ``bench/systems/<name>.py``: ``build``, ``counters``,
    ``state`` and ``describe`` of the system under test."""
    return importlib.import_module(f"systems.{name}")


def reference(name: str):
    """The plain reference module ``bench/reference/<name>.py``."""
    return importlib.import_module(f"reference.{name}")
