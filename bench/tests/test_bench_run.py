"""Whole runs of the harness on the CPU at a small size: the result line,
the guard against JAX, and the comparison refusing the bf16 control and
each fault a timed path can have."""
import json
import os
import subprocess
import sys

import pytest
import torch

import run as bench_run
from cells import SEED, small
from harness.manifest import BENCH

CPU = torch.device("cpu")
CELLS = ("marco-ivfpq.uniform512", "marco-flat.clients32")


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_result_line(name, trace):
    res = bench_run.run(small(name), SEED, 2.0, trace, CPU)
    line = json.loads(json.dumps(res))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    cell = small(name)
    want = {m["name"] for m in (cell.per_layer if trace else cell.end_to_end)}
    assert set(line["metrics"]) <= want
    if trace:
        # no kernel runs on the CPU: the device readers find nothing
        assert "db.query_host_ms" in line["metrics"]
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(line["metrics"]) == want
        # a slow CPU may finish no block inside a short window: qps >= 0
        assert all(m["value"] > 0 for n, m in line["metrics"].items()
                   if n != "qps")
    for c in line["checks"].values():
        assert c["value"] <= c["limit"]


@pytest.mark.parametrize("name", CELLS)
def test_the_bf16_control_is_refused(name):
    res = bench_run.run(small(name), SEED, 0.5, False, CPU, control=True)
    assert res["correct"] is True
    limits = small(name).workload["limits"]
    over = [n for n, v in res["control"].items() if v > limits[n]]
    assert set(over) & {"answer_gap", "score_err"}
    if "centroid_gap" in limits:
        # its own bf16 training: the centroids and codewords move too
        assert {"centroid_gap", "codeword_gap_median"} <= set(over)


class Broken:
    """A DB whose ``query`` answers wrong in one of three ways."""

    def __init__(self, db, fault):
        self._db, self.fault = db, fault

    def query(self, q, *args, **kwargs):
        s, i = self._db.query(q, *args, **kwargs)
        s, i = s.clone(), i.clone()
        Q = i.shape[0]
        if self.fault == "altered":      # an answer altered where produced
            i[:, -1] = (i[:, -1] + 1) % self._db.n
        elif self.fault == "half":       # half of the batch left out
            h = max(1, Q // 2)
            i[h:], s[h:] = i[:Q - h], s[:Q - h]
        elif self.fault == "misrouted":  # answers to the wrong requests
            i, s = i.roll(1, 0), s.roll(1, 0)
        return s, i

    def __getattr__(self, name):
        return getattr(self._db, name)


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", ["altered", "half", "misrouted"])
def test_a_broken_timed_path_is_refused(name, fault):
    res = bench_run.run(small(name), SEED, 0.5, False, CPU,
                        wrap=lambda db: Broken(db, fault))
    assert res["correct"] is False
    assert res["checks"]["answer_gap"]["value"] > res["checks"][
        "answer_gap"]["limit"]


def test_forbidden_modules_compare_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_x", sys)
    assert bench_run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert bench_run.forbidden_modules() == ["repro.core"]


def test_nothing_the_run_imports_is_jax():
    code = ("import sys; sys.path[:0] = [%r, %r]; import run, torch; "
            "from harness import data, manifest, peaks, record, trace; "
            "from drivers import blocks, clients; "
            "from systems import vectordb; "
            "from reference import flat, ivf_pq; import repro_torch; "
            "from repro_torch.serve.async_engine import AsyncQueryEngine; "
            "print(run.forbidden_modules())"
            % (str(BENCH), str(BENCH.parent / "src")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True,
                         env={k: v for k, v in os.environ.items()
                              if k != "PYTHONPATH"})
    assert out.stdout.strip() == "[]"


def test_cli_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("the machine has a CUDA card")
    out = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload",
         "marco-flat.clients32", "--seed", str(SEED), "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.gpu
def test_small_cell_on_the_card(cuda):
    res = bench_run.run(small("marco-ivfpq.uniform512", rows=100_000,
                              dim=768), SEED, 1.0, True, cuda)
    assert res["correct"] is True and res["device"]["busy_s"] > 0
