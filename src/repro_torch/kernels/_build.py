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


def aligned(t):
    """``t`` contiguous and 16-byte aligned (the kernels move 16-byte
    words): a copy only when a view starts off the boundary."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


# The properties a launch plan reads, for an H100 SXM (132 SMs, 227 KB of
# shared memory a block out of 228 KB an SM, 64K registers an SM): what
# ``card`` returns there, and what the CPU tests of the plans pass in.
H100 = {"sms": 132, "smem_block": 232_448, "smem_sm": 233_472,
        "regs_sm": 65_536}


def card(device) -> dict:
    """The launch plans' view of a CUDA card (keys as ``H100``)."""
    import torch
    p = torch.cuda.get_device_properties(device)
    smem_block = p.shared_memory_per_block_optin
    return {"sms": p.multi_processor_count, "smem_block": smem_block,
            "smem_sm": getattr(p, "shared_memory_per_multiprocessor",
                               smem_block + 1024),
            "regs_sm": getattr(p, "regs_per_multiprocessor", 65_536)}


_plans: dict = {}  # (plan function, arguments, device) -> plan


def cached_plan(fn, device, *args) -> dict:
    """``fn(*args[:-1], card(device), args[-1])``, a launch plan, computed
    once per shape and card: a wrapper asks for it at every launch, and a
    plan's search over row chunks costs host time a small launch notices."""
    key = (fn, args, device)
    got = _plans.get(key)
    if got is None:
        got = _plans[key] = fn(*args[:-1], card(device), args[-1])
    return got


def board_entries(k: int) -> int:
    """Entries of a sorted board holding k (csrc/topk_board.cuh
    sorted_slots): the least of 32, 64, 128, 256 that is at least k."""
    return next(p for p in (32, 64, 128, 256) if p >= k)


def row_chunks(N: int, q_tiles: int, slots: int, tile_rows: int) -> tuple:
    """(n_chunks, rows_per_chunk) of a (query tile, row chunk) grid: chunks
    of whole tiles of ``tile_rows`` that cover N once, at least enough for
    one block on each of the card's ``slots`` (SMs x blocks an SM) and, up
    to four times that, the count whose last wave is fullest (fewest on a
    tie)."""
    row_tiles = -(-N // tile_rows)
    lo = max(1, -(-slots // q_tiles))
    best, best_eff = lo, -1.0
    for nc in range(lo, 4 * lo + 1):
        blocks = q_tiles * nc
        eff = blocks / (-(-blocks // slots) * slots)
        if eff > best_eff + 1e-9:
            best, best_eff = nc, eff
    n_chunks = max(1, min(best, row_tiles, 65535))
    rows_per_chunk = tile_rows * -(-row_tiles // n_chunks)
    return -(-N // rows_per_chunk), rows_per_chunk


def merge_groups(n_chunks: int, Q: int, sms: int) -> int:
    """Blocks a query in the first level of a chunk-board merge: enough
    that Q x groups blocks cover about two per SM, each folding at least
    8 chunk boards; 1 (one level) where Q alone covers the card."""
    return max(1, min(-(-n_chunks // 8), 2 * sms // Q))


class LaunchCounter:
    """Launches of one kernel wrapper: the wrapper adds one where it
    launches its kernel and nowhere else, so a run can show that its main
    path went through the kernel."""

    def __init__(self, name: str):
        self.name = name
        self.n = 0

    def reset(self) -> None:
        self.n = 0
