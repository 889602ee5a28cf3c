#!/usr/bin/env python3
"""Probe the directory a snapshot would be written to, as
``chip_smoke.py`` phase 7 writes one: its free bytes and filesystem type,
the host's MemTotal, and the rate of 512 MB ``.npy`` files written and
fsync'd one after the other, then read back.

    python3 tools/disk_probe.py [--dir DIR] [--files 8]

The directory defaults to the system's temporary directory; the probe
writes into a directory of its own there and removes it.
"""
from __future__ import annotations

import argparse
import os
import shutil
import tempfile
import time

import numpy as np

CHUNK_BYTES = 512 << 20  # the checkpoint store's default chunk_mb


def fs_type(path: str) -> str:
    """The filesystem type of the longest mount point holding ``path``."""
    real, best = os.path.realpath(path), ("?", "")
    with open("/proc/mounts") as fh:
        for line in fh:
            parts = line.split()
            if len(parts) >= 3 and (real == parts[1] or real.startswith(
                    parts[1].rstrip("/") + "/")) and len(parts[1]) >= len(best[1]):
                best = (parts[2], parts[1])
    return f"{best[0]} on {best[1]}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dir", default=tempfile.gettempdir())
    ap.add_argument("--files", type=int, default=8)
    args = ap.parse_args(argv)
    with open("/proc/meminfo") as fh:
        mem = next(int(l.split()[1]) * 1024 for l in fh
                   if l.startswith("MemTotal:"))
    st = os.statvfs(args.dir)
    print(f"{args.dir}: {fs_type(args.dir)}, free "
          f"{st.f_bavail * st.f_frsize / 1e9:.2f} GB; MemTotal {mem / 1e9:.2f} GB")
    work = tempfile.mkdtemp(prefix="disk_probe_", dir=args.dir)
    try:
        buf = np.random.default_rng(0).integers(0, 255, CHUNK_BYTES,
                                                dtype=np.uint8)
        t0 = time.perf_counter()
        for i in range(args.files):
            path = os.path.join(work, f"c{i}.npy")
            np.save(path, buf)
            fd = os.open(path, os.O_RDONLY)
            os.fsync(fd)
            os.close(fd)
        w = time.perf_counter() - t0
        t0 = time.perf_counter()
        for i in range(args.files):
            np.load(os.path.join(work, f"c{i}.npy"))
        r = time.perf_counter() - t0
        total = args.files * CHUNK_BYTES / 1e9
        print(f"{args.files} files of 512 MB: written and fsync'd {w:.2f} s "
              f"({total / w:.2f} GB/s); read back {r:.2f} s "
              f"({total / r:.2f} GB/s, the page cache may serve it)")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
