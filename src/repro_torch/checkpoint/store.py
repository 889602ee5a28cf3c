"""Snapshots as npy leaf chunks and a JSON manifest (port of
``repro.checkpoint.store``, the same on-disk format).

    save(tree, directory, step, meta=...)   # step_<n>/ of <leaf>.<i>.npy
    arrays = load_arrays(directory, step, device="cuda")
    tree = restore(tree_like, directory, step)

The format is the reference's, so that either package reads the other's
snapshots:

  * a tree is nested dicts (or lists) of leaves; a leaf's key is its path
    joined by "/" (the reference's ``jax.tree_util`` key path), its files
    ``<key with "/" as "__">.<i>.npy``, each a (rows, rest) slab of at
    most ``chunk_mb``;
  * ``manifest.json`` holds ``step``, ``meta`` and, per leaf, its logical
    ``shape``, ``dtype`` and ``files``, and ``pspec``: the leaf's partition
    spec as a list (a tuple of axes as a list, ``None`` as null), or null
    for a leaf saved without one;
  * bf16 is written as a ``uint16`` view with ``"bfloat16"`` as the
    manifest dtype, as the reference writes ml_dtypes' bf16; the port
    reads it back through an int16 view to ``torch.bfloat16``, bit for
    bit, without ml_dtypes;
  * the commit protocol: leaves and manifest into ``step_<n>.tmp/`` (each
    file fsync'd), rename to ``step_<n>``, fsync the parent directory,
    with the reference's five ``snapshot.*`` crash points
    (``ft.faults.crashpoint``). ``valid_steps`` reports only steps whose
    manifest parses and whose files all exist.

Leaves are torch tensors on any device, numpy arrays, strings or Python
scalars. A save copies a device leaf to the host one chunk at a time, and
``load_arrays``/``restore`` fill one tensor per leaf (on ``device``) chunk
by chunk, so neither holds a second whole copy of a leaf on the host: at
8.8M rows the re-rank corpus is 27.4 GB.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.ft.faults import crashpoint

_NATIVE_KINDS = "?bifucOSU"


def _flatten_with_paths(tree, prefix=()):
    """[(key, leaf)] in the order the reference flattens: dict keys sorted,
    list items by index, None skipped (an empty subtree)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        items = sorted(tree.items())
    elif isinstance(tree, (list, tuple)):
        items = list(enumerate(tree))
    else:
        return [("/".join(str(p) for p in prefix), tree)]
    out = []
    for k, v in items:
        out.extend(_flatten_with_paths(v, prefix + (k,)))
    return out


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).replace("torch.", "")
    return str(leaf.dtype)


def _as_savable_leaf(leaf):
    """A tensor stays a tensor (copied chunk by chunk); anything else
    becomes a numpy array, as ``np.asarray`` makes it in the reference."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach()
    arr = np.asarray(leaf)
    if arr.dtype.kind not in _NATIVE_KINDS:  # a non-native type: its bits
        bits = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}
        arr = arr.view(bits[arr.dtype.itemsize])
    return arr


def _host_rows(part) -> np.ndarray:
    """One chunk on the host as numpy; bf16 as its uint16 bits."""
    if not isinstance(part, torch.Tensor):
        return part
    part = part.cpu()
    if part.dtype == torch.bfloat16:
        return part.view(torch.int16).numpy().view(np.uint16)
    return part.numpy()


def _fsync_file(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _fsync_dir(path: str) -> None:
    """Make a rename inside ``path`` durable. Best-effort on filesystems
    that refuse a directory fsync."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def save(tree, directory: str, step: int, *, pspecs=None, chunk_mb: int = 512,
         meta=None) -> str:
    """Write ``tree`` as step ``step`` of ``directory``; returns the
    committed path. ``meta`` (a JSON-able dict) is stamped into the
    manifest: index snapshots record the engine, metric, generation, live
    rows and, when durable, the WAL's ``wal_lsn``. A crash at any point
    leaves the previous snapshot intact or the new one committed.
    ``pspecs``: a tree like ``tree`` whose leaves are
    ``core.distributed.PartitionSpec`` (or None), recorded per leaf in the
    manifest for ``restore_resharded``, in the reference's form."""
    crashpoint("snapshot.write.pre")
    tmp = os.path.join(directory, f"step_{step:08d}.tmp")
    final = os.path.join(directory, f"step_{step:08d}")
    if os.path.exists(tmp):  # debris of a crashed earlier save
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": {}}
    if meta is not None:
        manifest["meta"] = dict(meta)
    spec_map = dict(_flatten_with_paths(pspecs))
    chunk_bytes = chunk_mb * 1024 * 1024
    for key, leaf in _flatten_with_paths(tree):
        arr = _as_savable_leaf(leaf)
        logical = _dtype_name(leaf if isinstance(leaf, torch.Tensor)
                              else np.asarray(leaf))
        shape = list(arr.shape)
        n_rows = arr.shape[0] if arr.ndim else 1
        rows = arr.reshape(n_rows, -1) if arr.ndim else arr.reshape(1, 1)
        nbytes = (arr.numel() * arr.element_size()
                  if isinstance(arr, torch.Tensor) else arr.nbytes)
        n_chunks = max(1, -(-nbytes // chunk_bytes))
        per = max(1, -(-n_rows // n_chunks))
        fname = key.replace("/", "__")
        files = []
        for ci, start in enumerate(range(0, n_rows, per)):
            f = f"{fname}.{ci}.npy"
            np.save(os.path.join(tmp, f), _host_rows(rows[start:start + per]))
            _fsync_file(os.path.join(tmp, f))
            files.append(f)
        spec = spec_map.get(key)
        manifest["leaves"][key] = {
            "shape": shape, "dtype": logical, "files": files,
            "pspec": None if spec is None else [_spec_entry(e) for e in spec]}
    with open(os.path.join(tmp, "manifest.json"), "w") as fh:
        json.dump(manifest, fh, indent=1)
        fh.flush()
        os.fsync(fh.fileno())
    crashpoint("snapshot.manifest.post")
    crashpoint("snapshot.rename.pre")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    crashpoint("snapshot.rename.post")
    _fsync_dir(directory)
    crashpoint("snapshot.fsync.post")
    return final


def _spec_entry(e):
    """One partition-spec entry as the manifest holds it: an axis name, a
    list of names, or None."""
    if e is None:
        return None
    if isinstance(e, (tuple, list)):
        return list(e)
    return str(e)


def _steps(directory: str) -> List[int]:
    return sorted(int(d.split("_")[1]) for d in os.listdir(directory)
                  if d.startswith("step_") and not d.endswith(".tmp"))


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = _steps(directory)
    return steps[-1] if steps else None


def is_valid_step(directory: str, step: int) -> bool:
    """A step is valid when its manifest parses and every file it names
    exists: the recovery side's definition of committed."""
    path = os.path.join(directory, f"step_{step:08d}")
    try:
        with open(os.path.join(path, "manifest.json")) as fh:
            manifest = json.load(fh)
        for leaf in manifest["leaves"].values():
            for f in leaf["files"]:
                if not os.path.exists(os.path.join(path, f)):
                    return False
    except (OSError, ValueError, KeyError):
        return False
    return True


def valid_steps(directory: str) -> List[int]:
    """Ascending committed and complete steps (see ``is_valid_step``)."""
    if not os.path.isdir(directory):
        return []
    return [s for s in _steps(directory) if is_valid_step(directory, s)]


def latest_valid_step(directory: str) -> Optional[int]:
    steps = valid_steps(directory)
    return steps[-1] if steps else None


def _load_manifest(directory: str, step: int):
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as fh:
        return path, json.load(fh)


def _torch_dtype(name: str) -> torch.dtype:
    """The tensor type a leaf of manifest dtype ``name`` reads into;
    uint32 (the reference's LSH signature words) reads as int32 bits, as
    ``core.convert.from_reference_state`` has it."""
    if name == "uint32":
        return torch.int32
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"leaf dtype {name!r} has no torch counterpart")
    return dt


def _is_text(name: str) -> bool:
    """A str or bytes leaf (the engine and metric names)."""
    try:
        return np.dtype(name).kind in "US"
    except TypeError:  # bfloat16: no numpy dtype without ml_dtypes
        return False


def _chunk_tensor(chunk: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """A loaded chunk as a CPU tensor of ``dtype``, by its bits where the
    widths agree (bf16 from uint16, int32 from uint32)."""
    if chunk.dtype.kind in "uV" and chunk.dtype.itemsize in (2, 4) \
            and dtype in (torch.bfloat16, torch.int32):
        signed = {2: np.int16, 4: np.int32}[chunk.dtype.itemsize]
        return torch.from_numpy(np.ascontiguousarray(chunk).view(signed)
                                ).view(dtype)
    return torch.from_numpy(np.ascontiguousarray(chunk)).to(dtype)


def _read_leaf(path: str, leaf: dict, device, stats=None):
    """One leaf: a tensor of the manifest's shape on ``device``, filled
    chunk by chunk; a string leaf as a numpy str array. ``stats`` (a dict)
    gains the seconds spent reading files and copying chunks into the
    tensor (synchronized on the card), and the bytes read."""
    shape = tuple(leaf["shape"])
    if _is_text(leaf["dtype"]):
        parts = [np.load(os.path.join(path, f)) for f in leaf["files"]]
        return np.concatenate(parts).reshape(shape)
    dtype = _torch_dtype(leaf["dtype"])
    out = torch.empty(shape, dtype=dtype, device=device)
    flat = out.reshape(shape[0] if shape else 1, -1)
    start = 0
    for f in leaf["files"]:
        t0 = time.perf_counter()
        chunk = np.load(os.path.join(path, f))
        t1 = time.perf_counter()
        n = chunk.shape[0]
        if chunk.ndim != 2 or start + n > flat.shape[0] \
                or chunk.shape[1] != flat.shape[1]:
            raise ValueError(f"{f}: chunk of shape {chunk.shape} does not fit "
                             f"leaf {shape} at row {start}")
        flat[start:start + n] = _chunk_tensor(chunk, dtype)
        start += n
        if stats is not None:
            if out.is_cuda:
                torch.cuda.synchronize(out.device)
            stats["read_s"] = stats.get("read_s", 0.0) + t1 - t0
            stats["upload_s"] = (stats.get("upload_s", 0.0)
                                 + time.perf_counter() - t1)
            stats["bytes"] = stats.get("bytes", 0) + chunk.nbytes
    if start != flat.shape[0]:
        raise ValueError(f"leaf {shape}: its chunks hold {start} of "
                         f"{flat.shape[0]} rows")
    return out


def load_meta(directory: str, step: Optional[int] = None) -> dict:
    """The manifest's ``meta`` stamp (empty for snapshots without one)."""
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {directory!r}")
    _path, manifest = _load_manifest(directory, step)
    return manifest.get("meta", {})


def load_arrays(directory: str, step: int, device=None, stats=None) -> dict:
    """Every leaf as a flat {key: value} dict, shapes from the manifest
    alone (how index snapshots restore: a fresh engine has nothing to
    mirror). Array leaves become tensors on ``device`` (the CPU when None),
    filled chunk by chunk; string leaves become ``str`` and 0-d leaves
    Python scalars, the form ``load_state`` takes (as
    ``core.convert.from_reference_state`` gives it). ``stats`` (a dict)
    gains ``read_s``, ``upload_s`` and ``bytes`` (``_read_leaf``)."""
    path, manifest = _load_manifest(directory, step)
    out = {}
    for key, leaf in manifest["leaves"].items():
        value = _read_leaf(path, leaf, device, stats)
        if isinstance(value, np.ndarray):
            value = str(value) if value.ndim == 0 else value
        elif value.dim() == 0:
            value = value.item()
        out[key] = value
    return out


def restore(tree_like, directory: str, step: int):
    """Restore into the structure of ``tree_like`` (nested dicts or lists
    of tensors): each leaf comes back with the target's shape, dtype and
    device."""
    path, manifest = _load_manifest(directory, step)
    keys = dict(_flatten_with_paths(tree_like))
    for key in manifest["leaves"]:
        if key not in keys:
            raise KeyError(f"manifest leaf {key} missing from target tree")

    def leaf(key, node):
        target = torch.as_tensor(node)
        return _read_like(path, manifest, key, target, target.device)

    return _map_leaves(tree_like, leaf)


def _map_leaves(tree, fn, prefix=()):
    """``tree`` (nested dicts, lists, tuples) with each leaf replaced by
    fn(key, leaf); None stays None."""
    if isinstance(tree, dict):
        return {k: _map_leaves(v, fn, prefix + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(v, fn, prefix + (i,))
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn("/".join(str(p) for p in prefix), tree)


def _read_like(path, manifest, key, like, device):
    """Leaf ``key`` read onto ``device``, checked against the shape of
    ``like`` and cast to its dtype (a torch or numpy dtype)."""
    got = _read_leaf(path, manifest["leaves"][key], device)
    if tuple(got.shape) != tuple(like.shape):
        raise ValueError(f"{key}: saved shape {tuple(got.shape)}, target "
                         f"{tuple(like.shape)}")
    dtype = like.dtype
    if not isinstance(dtype, torch.dtype):
        dtype = torch.from_numpy(np.zeros(0, dtype)).dtype
    return got.to(dtype)


def restore_resharded(tree_like, directory: str, step: int, mesh,
                      make_sharding):
    """Elastic re-mesh restore: each leaf of ``tree_like`` read as saved,
    then placed on the new ``mesh`` by ``make_sharding(key, leaf)``, a
    ``core.distributed.NamedSharding``: a row-sharded leaf comes back as
    ``core.distributed.ShardedRows`` (its slabs on their devices), a
    replicated one as a tensor on the mesh's merge device. The saved
    partition spec is in the manifest, but the new mesh may have other
    axes or fewer devices: the callback decides, as in the reference.
    Leaves keep the dtype of ``tree_like``'s leaves."""
    path, manifest = _load_manifest(directory, step)
    return _map_leaves(tree_like, lambda key, leaf: make_sharding(
        key, leaf).place(_read_like(path, manifest, key, leaf, "cpu")))


class AsyncSaveHandle:
    """Completion handle of ``CheckpointStore.save_async``: a save that
    fails after its retries stores its exception here, and ``result()`` or
    the store's next ``wait()`` raises it on the caller's thread."""

    def __init__(self, step: int):
        self.step = step
        self.path: Optional[str] = None
        self.attempts = 0
        self.copy_s = 0.0   # the host copy, on the caller's thread
        self.write_s = 0.0  # the background write, retries included
        self._exc: Optional[BaseException] = None
        self._done = threading.Event()

    def done(self) -> bool:
        return self._done.is_set()

    def exception(self, timeout: Optional[float] = None):
        self._done.wait(timeout)
        return self._exc

    def result(self, timeout: Optional[float] = None) -> str:
        """The committed snapshot's path; raises the terminal failure."""
        self._done.wait(timeout)
        if self._exc is not None:
            raise self._exc
        return self.path


def _host_copy(tree):
    if isinstance(tree, dict):
        return {k: _host_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host_copy(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().clone()
    return np.array(tree) if isinstance(tree, np.ndarray) else tree


class CheckpointStore:
    """A directory of steps with retention (``keep``) and background
    saves. ``retries``/``backoff_s``: an OSError during a background save
    is retried with exponential backoff before it is declared terminal on
    the handle."""

    def __init__(self, directory: str, keep: int = 3, retries: int = 3,
                 backoff_s: float = 0.05):
        self.directory = directory
        self.keep = keep
        self.retries = retries
        self.backoff_s = backoff_s
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._handle: Optional[AsyncSaveHandle] = None

    def save(self, tree, step: int, *, pspecs=None):
        out = save(tree, self.directory, step, pspecs=pspecs)
        self._gc()
        return out

    def save_async(self, tree, step: int, *, pspecs=None) -> AsyncSaveHandle:
        """Copy the tree to host memory now and write it on a background
        thread; returns the handle (``copy_s`` and, once done,
        ``write_s`` time the two parts)."""
        t0 = time.perf_counter()
        host_tree = _host_copy(tree)
        copy_s = time.perf_counter() - t0
        self.wait()
        handle = AsyncSaveHandle(step)
        handle.copy_s = copy_s

        def _run():
            t_write = time.perf_counter()
            try:
                for attempt in range(self.retries + 1):
                    handle.attempts = attempt + 1
                    try:
                        handle.path = save(host_tree, self.directory, step,
                                           pspecs=pspecs)
                        self._gc()
                        return
                    except OSError:
                        if attempt == self.retries:
                            raise
                        time.sleep(self.backoff_s * (2 ** attempt))
            except BaseException as e:  # terminal: kept for the caller
                handle._exc = e
            finally:
                handle.write_s = time.perf_counter() - t_write
                handle._done.set()

        self._handle = handle
        self._thread = threading.Thread(target=_run, daemon=True)
        self._thread.start()
        return handle

    def wait(self):
        """Join the background save; raises its terminal failure."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
            handle, self._handle = self._handle, None
            if handle is not None and handle._exc is not None:
                raise handle._exc

    def latest_step(self):
        return latest_step(self.directory)

    def valid_steps(self):
        return valid_steps(self.directory)

    def restore(self, tree_like, step: Optional[int] = None):
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory!r}")
        return restore(tree_like, self.directory, step), step

    def restore_resharded(self, tree_like, mesh, make_sharding, step=None):
        return restore_resharded(tree_like, self.directory, step, mesh,
                                 make_sharding)

    def _gc(self):
        for s in _steps(self.directory)[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)
