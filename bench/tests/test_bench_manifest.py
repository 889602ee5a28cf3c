"""BENCHMARK.json keeps to its format and limits, and every name in it
resolves to its files."""
import json
import re

from harness import manifest
from harness.manifest import ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_command():
    man = manifest.load_manifest()
    assert set(man) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert man["command"] == ["python3", "bench/run.py"]
    assert man["paths"] == ["bench"]
    assert 1 <= man["run_seconds"] <= 51
    assert len(json.dumps(man)) <= 64 * 1024


def test_names_units_and_keys():
    man = manifest.load_manifest()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in man[group]]
        assert len(names) == len(set(names)), group
        for n in names:
            assert NAME.match(n), n
    for c in man["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("bench/") and (ROOT / c["file"]).exists()
    for w in man["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in man["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert UNIT.match(m["unit"]) and m["source"] in ("host_clock",
                                                         "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in {m["name"] for m in man["end_to_end"]}
    for m in man["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert UNIT.match(m["unit"])
        assert m["moves"] in {e["name"] for e in man["end_to_end"]}


def test_every_cell_resolves():
    man = manifest.load_manifest()
    used = set()
    for w in man["workloads"]:
        cell = manifest.cell(w["name"])
        used.add(w["config"])
        assert cell.config["name"] == w["config"]
        assert hasattr(manifest.driver(cell.traffic["driver"]), "window")
        system = manifest.system(cell.config["system"])
        assert all(callable(getattr(system, f)) for f in
                   ("build", "counters", "state", "describe"))
        assert set(cell.workload["limits"]) >= {"answer_gap", "score_err",
                                                "bad_answers"}
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
        assert len(cell.end_to_end) >= 2 and cell.per_layer
        for m in cell.end_to_end + cell.per_layer:
            assert callable(manifest.metric_reader(m["name"]))
        ref = manifest.reference(cell.config["reference"])
        assert all(callable(getattr(ref, f)) for f in
                   ("prepare", "judge", "control"))
    assert used == {c["name"] for c in man["configs"]}


def test_configs_state_source_cut_and_guarantee():
    man = manifest.load_manifest()
    for c in man["configs"]:
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["source"] == c["source"]
        assert conf["reduced"] == c["reduced"] == []
        assert conf["data"]["rows"] == 8_841_823
        assert conf["data"]["dim"] == 768
        assert conf["guarantee"] and conf["assumed"]
