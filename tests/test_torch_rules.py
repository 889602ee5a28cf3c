"""Rules the port keeps, checked on the CPU.

1. Importing ``repro_torch`` (its serving, checkpoint, WAL, fault and
   search modules too) loads neither JAX, ml_dtypes nor the JAX package.
2. No module of ``src/repro_torch``, not ``chip_smoke.py`` and neither
   ``tools/ivf_dispatch.py`` nor ``tools/ivf_kernels.py`` imports ``jax``,
   ``ml_dtypes`` or ``repro``.
3. Entry points run on the card: ``VectorDB()`` without a device raises
   when there is none.
4. Kernel dispatch follows the tensor: ``use_kernel=True`` on a CPU tensor
   raises, a CUDA tensor takes the kernel unless ``use_kernel=False``.
5. The port selects its top-k by sorting, never with ``torch.topk``,
   compiles nothing with ``torch.compile`` and never calls PyTorch's
   fused ``scaled_dot_product_attention``.
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
    REPO / "chip_smoke.py", REPO / "tools" / "ivf_dispatch.py",
    REPO / "tools" / "ivf_kernels.py"]


def test_import_loads_no_jax():
    code = ("import json, sys, repro_torch, repro_torch.core.convert, "
            "repro_torch.serve, repro_torch.checkpoint, repro_torch.core.wal, "
            "repro_torch.ft, repro_torch.search; "
            "print(json.dumps([m for m in sys.modules if m.split('.')[0] "
            "in ('jax', 'jaxlib', 'repro', 'ml_dtypes')]))")
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
           if m.split(".")[0] in ("jax", "jaxlib", "repro", "ml_dtypes")]
    assert not bad, f"{path} imports {bad}"


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        VectorDB()
    with pytest.raises(RuntimeError, match="CUDA"):
        VectorDB("ivf_pq")
    with pytest.raises(RuntimeError, match="CUDA"):
        VectorDB("lsh")
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


@pytest.mark.parametrize("mode", ["auto", "per_query", "blocked",
                                  "run_resident"])
def test_every_adc_entry_refuses_the_kernel_on_cpu(mode):
    """``use_kernel=True`` on CPU tensors raises in every ADC mode and in
    the flat ADC scan, before any grid or schedule is chosen."""
    codes = torch.zeros((2, 8, 4), dtype=torch.uint8)
    ids = torch.zeros((2, 8), dtype=torch.int32)
    visit = torch.zeros((1, 1), dtype=torch.int32)
    luts = torch.zeros((1, 4, 16))
    with pytest.raises(ValueError, match="CUDA"):
        ops.ivf_adc_topk(codes, ids, visit, luts, k=2, use_kernel=True,
                         mode=mode)
    with pytest.raises(ValueError, match="CUDA"):
        ops.adc_topk(torch.zeros((9, 4), dtype=torch.uint8), luts, k=2,
                     use_kernel=True)


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
        # PyTorch's fused attention, however it is reached
        if (isinstance(node, ast.Attribute)
                and node.attr == "scaled_dot_product_attention"):
            calls.append("scaled_dot_product_attention")
        if isinstance(node, ast.ImportFrom) and any(
                a.name == "scaled_dot_product_attention" for a in node.names):
            calls.append("scaled_dot_product_attention")
    if path.name == "chip_smoke.py":
        # chip_smoke times torch.topk and scaled_dot_product_attention once
        # each as the library yardsticks
        calls = [c for c in calls
                 if c not in ("torch.topk", "scaled_dot_product_attention")]
    assert not calls, f"{path} calls {calls}"


def test_flat_query_runs_the_plain_version_on_cpu():
    corpus = np.random.default_rng(0).normal(size=(64, 8)).astype(np.float32)
    db = VectorDB("flat", metric="dot", device="cpu").load(corpus)
    ops.reset_launch_counts()
    s, i = db.query(corpus[:2], k=3)
    assert s.shape == (2, 3) and i.device.type == "cpu"
    assert ops.launch_counts() == {
        "topk_distance": 0, "pq_adc": 0, "ivf_adc": 0, "ivf_adc_blocked": 0,
        "ivf_adc_run_resident": 0, "hamming": 0, "flash_attention": 0}


NEW_PORT_MODULES = ["configs/base.py", "configs/thistle_sbert.py",
                    "data/marco.py", "models/layers.py", "models/attention.py",
                    "models/transformer.py", "models/encoder.py",
                    "kernels/flash_attention.py"]


@pytest.mark.parametrize("module", NEW_PORT_MODULES)
def test_text_path_modules_are_checked_for_imports(module):
    """The text path's modules are among the files the import rule walks."""
    assert REPO / "src" / "repro_torch" / module in PORT_FILES


def test_flash_attention_refuses_the_kernel_on_cpu():
    x = torch.zeros((1, 8, 2, 16))
    with pytest.raises(ValueError, match="CUDA"):
        ops.flash_attention(x, x, x, causal=False, use_kernel=True)
    from repro_torch.configs import thistle_sbert
    from repro_torch.models.attention import multihead_attention
    with pytest.raises(ValueError, match="CUDA"):
        multihead_attention(x, x, x, thistle_sbert.SMOKE, causal=False,
                            window=None, use_kernel=True)
    ops.reset_launch_counts()
    ops.flash_attention(x, x, x, causal=False)
    assert ops.launch_counts()["flash_attention"] == 0


def test_sdpa_in_a_port_file_is_caught(tmp_path):
    """The rule sees PyTorch's fused attention through an alias and
    through a from-import."""
    for src in ("import torch.nn.functional as F\n"
                "F.scaled_dot_product_attention(q, k, v)\n",
                "from torch.nn.functional import scaled_dot_product_attention\n"):
        path = tmp_path / "mod.py"
        path.write_text(src)
        with pytest.raises(AssertionError, match="scaled_dot_product"):
            test_no_torch_topk_or_compile_in_the_port(path)


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


def test_new_kernel_limits_are_named():
    """pq_adc and the grouped grids refuse k above the boards' size with
    the limit named, before anything touches the card."""
    from repro_torch.kernels.ivf_adc import (KMAX, ivf_adc_blocked_cuda,
                                             ivf_adc_run_resident_cuda)
    from repro_torch.kernels.pq_adc import pq_adc_cuda
    with pytest.raises(ValueError, match=str(KMAX)):
        pq_adc_cuda(torch.zeros((400, 4), dtype=torch.uint8),
                    torch.zeros((2, 4, 16)), torch.zeros(400), k=KMAX + 1)
    codes = torch.zeros((2, 8, 4), dtype=torch.uint8)
    sched = {key: torch.zeros((8, 8), dtype=torch.int32)
             for key in ("sq", "st")}
    for fn in (ivf_adc_blocked_cuda, ivf_adc_run_resident_cuda):
        with pytest.raises(ValueError, match=str(KMAX)):
            fn(codes, torch.zeros((2, 8), dtype=torch.int32),
               torch.zeros((1, 1), dtype=torch.int32), sched,
               torch.zeros((1, 4, 16)), torch.zeros((1, 1)), k=KMAX + 1)


def test_pq_adc_table_limit_is_named():
    """A table too large for a block's shared memory is refused with the
    sizes named (pq_adc stages the first 256 entries of each subspace);
    otherwise the plan's largest query tile is what fits."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import pq_adc as P
    card = _build.H100
    with pytest.raises(ValueError, match="m=256, W=256 float32"):
        P.plan(1000, 4, 256, 256, 10, "float32", 0, card)
    assert P.fit_qt(64, 2973, 10, "float32", 1, card) == 3
    assert P.fit_qt(16, 256, 10, "int8", 0, card) == P.MAX_QT


def test_hamming_entries_refuse_the_kernel_on_cpu():
    codes = torch.zeros((2, 8, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        ops.hamming(codes[:, :1], codes, use_kernel=True)
    with pytest.raises(ValueError, match="CUDA"):
        ops.hamming_shortlist(codes[:, :1], codes, 4, use_kernel=True)


def test_hamming_shortlist_limit_is_named():
    """Above the boards' size the shortlist kernel refuses with the limit
    named, before anything touches the card; so do more words a row than
    the kernel holds in registers."""
    from repro_torch.kernels.hamming import (MAX_WORDS, hamming_cuda,
                                             hamming_shortlist_cuda)
    from repro_torch.kernels.topk_distance import KMAX
    codes = torch.zeros((4, 400, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match=str(KMAX)):
        hamming_shortlist_cuda(codes[:, :2], codes, KMAX + 1)
    wide = torch.zeros((3, 400, 11), dtype=torch.int32)
    for call in (lambda: hamming_cuda(wide[:, :2], wide),
                 lambda: hamming_shortlist_cuda(wide[:, :2], wide, 10)):
        with pytest.raises(ValueError, match=str(MAX_WORDS)):
            call()


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
    names = ["topk_distance", "ivf_adc", "pq_adc", "hamming",
             "flash_attention"]
    _build.build_all(names)
    lines = calls.read_text().splitlines()
    assert len(lines) == 5
    assert all("arch=compute_90a,code=sm_90a" in ln for ln in lines)
    assert sorted(ln.split()[-1].rsplit("/", 1)[-1] for ln in lines) == sorted(
        f"{n}.cu" for n in names)
    assert "registers" in _build.build_log("ivf_adc")
    _build.build_all(names)  # keyed on the sources
    assert len(calls.read_text().splitlines()) == 5


def test_build_failure_names_the_source(tmp_path, monkeypatch):
    from repro_torch.kernels import _build
    monkeypatch.setenv("CUDA_HOME", _stand_in_nvcc(
        tmp_path, 'echo "error: expected a ;" ; exit 2\n'))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="topk_distance.cu"):
        _build.build_all(["topk_distance", "ivf_adc"])
    assert not list((tmp_path / "build").glob("*.so"))
