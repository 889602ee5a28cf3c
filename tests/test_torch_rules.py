"""Rules the port keeps, checked on the CPU.

1. Importing ``repro_torch`` loads neither JAX nor the JAX package.
2. No module of ``src/repro_torch`` and not ``chip_smoke.py`` imports
   ``jax`` or ``repro``.
3. Entry points run on the card: ``VectorDB()`` without a device raises
   when there is none.
4. Kernel dispatch follows the tensor: ``use_kernel=True`` on a CPU tensor
   raises, a CUDA tensor takes the kernel unless ``use_kernel=False``.
5. The port selects its top-k by sorting, never with ``torch.topk``, and
   compiles nothing with ``torch.compile``.
"""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro_torch import VectorDB  # noqa: E402
from repro_torch.device import kernel_path  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"]


def test_import_loads_no_jax():
    code = ("import json, sys, repro_torch, repro_torch.core.convert; "
            "print(json.dumps([m for m in sys.modules if m.split('.')[0] "
            "in ('jax', 'jaxlib', 'repro')]))")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.name)
def test_port_file_imports_no_jax(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path} imports {bad}"


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        VectorDB()
    with pytest.raises(RuntimeError, match="CUDA"):
        VectorDB("ivf_pq")
    assert VectorDB(device="cpu").device.type == "cpu"


def test_use_kernel_true_on_cpu_raises():
    x = torch.zeros((4, 3))
    with pytest.raises(ValueError, match="CUDA"):
        ops.topk_distance(x, x, k=2, use_kernel=True)
    codes = torch.zeros((2, 8, 4), dtype=torch.uint8)
    ids = torch.zeros((2, 8), dtype=torch.int32)
    visit = torch.zeros((1, 1), dtype=torch.int32)
    luts = torch.zeros((1, 4, 16))
    with pytest.raises(ValueError, match="CUDA"):
        ops.ivf_adc_topk(codes, ids, visit, luts, k=2, use_kernel=True)


class _CudaLike:
    is_cuda = True
    device = "cuda:0"


def test_dispatch_follows_the_tensor():
    cpu = torch.zeros(1)
    assert kernel_path(cpu) is False
    assert kernel_path(cpu, use_kernel=False) is False
    assert kernel_path(_CudaLike()) is True
    assert kernel_path(_CudaLike(), use_kernel=True) is True
    assert kernel_path(_CudaLike(), use_kernel=False) is False


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.name)
def test_no_torch_topk_or_compile_in_the_port(path):
    calls = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Attribute) and node.attr in ("topk", "compile"):
            if isinstance(node.value, ast.Name) and node.value.id == "torch":
                calls.append(f"torch.{node.attr}")
    if path.name == "chip_smoke.py":
        # chip_smoke times torch.topk once as the library yardstick
        calls = [c for c in calls if c != "torch.topk"]
    assert not calls, f"{path} calls {calls}"


def test_flat_query_runs_the_plain_version_on_cpu():
    corpus = np.random.default_rng(0).normal(size=(64, 8)).astype(np.float32)
    db = VectorDB("flat", metric="dot", device="cpu").load(corpus)
    ops.reset_launch_counts()
    s, i = db.query(corpus[:2], k=3)
    assert s.shape == (2, 3) and i.device.type == "cpu"
    assert ops.launch_counts() == {"topk_distance": 0, "ivf_adc": 0}


def test_kernel_k_limit_is_named():
    """Above the boards' size the kernel wrappers refuse with the limit,
    before anything touches the card."""
    from repro_torch.kernels.ivf_adc import ivf_adc_cuda
    from repro_torch.kernels.topk_distance import KMAX, topk_distance_cuda
    x = torch.zeros((400, 3))
    with pytest.raises(ValueError, match=str(KMAX)):
        topk_distance_cuda(x, x[:2], torch.zeros(400), k=KMAX + 1, l2=False)
    codes = torch.zeros((2, 8, 4), dtype=torch.uint8)
    with pytest.raises(ValueError, match=str(KMAX)):
        ivf_adc_cuda(codes, torch.zeros((2, 8), dtype=torch.int32),
                     torch.zeros((1, 1), dtype=torch.int32),
                     torch.zeros((1, 4, 16)), torch.zeros((1, 1)), k=KMAX + 1)


def _stand_in_nvcc(tmp_path, body):
    """A CUDA_HOME whose bin/nvcc is a shell script: the build's command
    line, caching and failure handling run without the toolkit."""
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text("#!/bin/sh\n" + body)
    nvcc.chmod(0o755)
    return str(tmp_path / "cuda")


def test_build_runs_one_nvcc_per_source_and_caches(tmp_path, monkeypatch):
    from repro_torch.kernels import _build
    calls = tmp_path / "calls"
    home = _stand_in_nvcc(tmp_path, f'''
echo "$@" >> {calls}
while [ "$#" -gt 0 ]; do [ "$1" = "-o" ] && out="$2"; shift; done
echo "ptxas info    : Used 40 registers" && echo lib > "$out"
''')
    monkeypatch.setenv("CUDA_HOME", home)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    _build.build_all(["topk_distance", "ivf_adc"])
    lines = calls.read_text().splitlines()
    assert len(lines) == 2
    assert all("arch=compute_90a,code=sm_90a" in ln for ln in lines)
    assert "registers" in _build.build_log("ivf_adc")
    _build.build_all(["topk_distance", "ivf_adc"])  # keyed on the sources
    assert len(calls.read_text().splitlines()) == 2


def test_build_failure_names_the_source(tmp_path, monkeypatch):
    from repro_torch.kernels import _build
    monkeypatch.setenv("CUDA_HOME", _stand_in_nvcc(
        tmp_path, 'echo "error: expected a ;" ; exit 2\n'))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="topk_distance.cu"):
        _build.build_all(["topk_distance", "ivf_adc"])
    assert not list((tmp_path / "build").glob("*.so"))
