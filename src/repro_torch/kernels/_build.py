"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles on its own with ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface, loaded with ``ctypes``.
Nothing is built when a module is imported: the first launch builds what
it needs, and ``build_all`` builds every source at once, one ``nvcc`` each,
all started together. Libraries land in ``src/repro_torch/_build/`` (listed
in ``.gitignore``) under a name keyed on a hash of every file in ``csrc/``
and the flags, so an edited source builds anew and an unchanged one is
loaded as it is.

Every C entry point returns ``cudaGetLastError()`` after its launches;
``check`` raises on anything but 0, since a refused launch never runs and a
later synchronise would not report it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict = {}     # name -> ctypes.CDLL
_seconds: dict = {}  # name -> build seconds in this process (0 if cached)


def _nvcc() -> str:
    for env in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(env)
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the CUDA kernels")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return h.hexdigest()[:16]


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_source_hash()}.so"


def _start(name: str):
    """Start nvcc for csrc/<name>.cu; returns (Popen, tmp .so, final .so)
    or None when the library is already built."""
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp,
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, job, t0: float):
    """Wait for one nvcc; returns its error message, or None."""
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        return f"nvcc failed on csrc/{name}.cu:\n{log}"
    os.replace(tmp, out)  # atomic: a concurrent load sees a whole file
    out.with_suffix(".log").write_text(log)
    _seconds[name] = time.perf_counter() - t0
    return None


def build_all(names) -> dict:
    """Build the named kernels in parallel; returns {name: seconds}. Every
    nvcc started is waited for before a failure is raised."""
    t0 = time.perf_counter()
    jobs = {n: _start(n) for n in names}
    errors = [_finish(n, job, t0) for n, job in jobs.items() if job is not None]
    errors = [e for e in errors if e]
    if errors:
        raise RuntimeError("\n".join(errors))
    return {n: _seconds.setdefault(n, 0.0) for n in names}


def build_log(name: str) -> str:
    """nvcc's output for the kernel (ptxas: registers, shared memory,
    spill stores and loads of each function)."""
    path = _lib_path(name).with_suffix(".log")
    return path.read_text() if path.exists() else ""


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The kernel's library, built at first use. ``signatures`` maps each
    C function to (argtypes, restype); pointers and the stream are
    ``c_void_p`` so that ctypes passes them whole."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build_all([name])
    lib = ctypes.CDLL(str(_lib_path(name)))
    for fn, (argtypes, restype) in signatures.items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = restype
    err = lib.thistle_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    _libs[name] = lib
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    if code != 0:
        msg = lib.thistle_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


class LaunchCounter:
    """Launches of one kernel wrapper: the wrapper adds one where it
    launches its kernel and nowhere else, so a run can show that its main
    path went through the kernel."""

    def __init__(self, name: str):
        self.name = name
        self.n = 0

    def reset(self) -> None:
        self.n = 0
