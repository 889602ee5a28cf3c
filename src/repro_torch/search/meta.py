"""Metadata columns and the predicate AST -> id bitmaps (port of
``repro.search.meta``; host numpy, as in the reference, so that its
snapshot leaves and ``filter_hash`` values equal the reference's).

A filter is a mask change, not a shape change: a predicate compiles to one
boolean bitmap over the id space, which ``VectorDB.query(where=...)`` ANDs
into the engine's validity (``flat``, ``pq`` and ``scan_all``: the live
mask; ``ivf_pq``: its bucket ids, through ``kernels.ops.mask_allowed_ids``),
so a filtered-out row reads like a tombstone and every kernel serves the
filtered query unchanged.

The store is columnar and keyed by slot id, the engines' stable, never
reused row addresses: typed columns (int, float, bool, categorical) with a
presence mask, grown on a power-of-two ladder. ``VectorDB`` keeps it in
step with the writes (insert and upsert attach rows, upsert replaces,
delete clears presence, compact changes nothing), and the columns ride
snapshots as ``metastore__*`` leaves and the WAL as a record's ``meta``.

Predicates: ``Eq``, ``Range``, ``In``, ``And``, ``Or``, ``Not`` (and the
operators ``&``, ``|``, ``~``). A row with no value in a column matches no
Eq, Range or In on it; ``Not`` flips the whole mask, so ``~Eq("t", "a")``
matches rows with no ``t``. ``Range`` is numeric only, inclusive, None
unbounded. Categorical columns store int32 codes and a vocabulary; an
unseen category matches nothing. ``Predicate.key()`` is a stable structural
key (the serving fronts group reads by it; ``filter_hash`` salts the plan
ledger with its crc32).

One departure, in speed only: the reference writes a column row by row in
Python. Here a batch whose values are all of the column's kind (and whose
ids are distinct) is written with one numpy assignment, and a categorical
batch takes its codes in order of first appearance, as the row loop
assigns them; anything else (None entries, mixed kinds) takes the
reference's row loop. 8.8M rows load in seconds, not minutes.
"""
from __future__ import annotations

import json
import zlib
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch

STATE_PREFIX = "metastore__"

_KINDS = ("int", "float", "bool", "cat")
_DTYPES = {"int": np.int64, "float": np.float64, "bool": np.bool_,
           "cat": np.int32}
_ARRAY_KINDS = {"b": "bool", "i": "int", "u": "int", "f": "float",
                "U": "cat"}


def _kind_of(value) -> str:
    """Column kind implied by a Python value (bool before int: bool is a
    subclass of int)."""
    if isinstance(value, (bool, np.bool_)):
        return "bool"
    if isinstance(value, (int, np.integer)):
        return "int"
    if isinstance(value, (float, np.floating)):
        return "float"
    if isinstance(value, str):
        return "cat"
    raise TypeError(f"unsupported metadata value {value!r} "
                    f"(int/float/bool/str only)")


def _kinds_of(vals) -> Optional[set]:
    """The set of kinds of a batch's values, or None when some value is
    None or of no kind (those batches take the row loop)."""
    if isinstance(vals, np.ndarray):
        kind = _ARRAY_KINDS.get(vals.dtype.kind)
        return None if kind is None else {kind}
    kinds = set()
    for t in set(map(type, vals)):
        if t is type(None):
            return None
        try:
            kinds.add(_kind_of(t()))
        except TypeError:
            return None
    return kinds


def _grow_to(arr: np.ndarray, n: int, fill) -> np.ndarray:
    """Power-of-two capacity growth, the reference's ladder."""
    if arr.shape[0] >= n:
        return arr
    cap = max(64, int(arr.shape[0]))
    while cap < n:
        cap *= 2
    out = np.full((cap,), fill, arr.dtype)
    out[: arr.shape[0]] = arr
    return out


def _distinct(ids: np.ndarray) -> bool:
    if ids.size < 2 or bool(np.all(ids[1:] > ids[:-1])):
        return True
    return np.unique(ids).size == ids.size


def _json_list(vals) -> list:
    """A column's values as JSON scalars (the WAL form)."""
    return vals.tolist() if isinstance(vals, np.ndarray) else list(vals)


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class Column:
    """One typed column: values and presence, indexed by slot id."""

    def __init__(self, kind: str):
        if kind not in _KINDS:
            raise ValueError(f"column kind {kind!r} not in {_KINDS}")
        self.kind = kind
        self.values = np.zeros((0,), _DTYPES[kind])
        self.present = np.zeros((0,), np.bool_)
        # categorical: value <-> int32 code
        self.vocab: Dict[str, int] = {}
        self.rev: List[str] = []

    def code_of(self, value: str, *, create: bool) -> Optional[int]:
        code = self.vocab.get(value)
        if code is None and create:
            code = len(self.rev)
            self.vocab[value] = code
            self.rev.append(value)
        return code

    def set_rows(self, ids: np.ndarray, raw: Sequence) -> None:
        """Write values for ``ids`` (presence True); None entries clear."""
        hi = int(ids.max()) + 1 if ids.size else 0
        self.values = _grow_to(self.values, hi, 0)
        self.present = _grow_to(self.present, hi, False)
        kinds = _kinds_of(raw) if ids.size else None
        if kinds and _distinct(ids) and (
                kinds == {self.kind}
                or (self.kind == "float" and kinds <= {"int", "float"})):
            self._set_bulk(ids, raw)
            return
        for i, v in zip(ids, raw):
            if v is None:
                self.present[i] = False
                continue
            got = _kind_of(v)
            # ints are acceptable floats; anything else must match exactly
            if got != self.kind and not (self.kind == "float" and got == "int"):
                raise TypeError(
                    f"column holds {self.kind!r} values, got {v!r}")
            if self.kind == "cat":
                self.values[i] = self.code_of(v, create=True)
            else:
                self.values[i] = v
            self.present[i] = True

    def _set_bulk(self, ids: np.ndarray, raw) -> None:
        """``set_rows`` for distinct ids and values all of the column's
        kind: what the row loop writes, in one assignment."""
        if self.kind == "cat":
            uniq, first, inv = np.unique(np.asarray(raw), return_index=True,
                                         return_inverse=True)
            codes = np.empty(uniq.shape[0], np.int32)
            for u in np.argsort(first, kind="stable"):  # first appearance
                codes[u] = self.code_of(str(uniq[u]), create=True)
            self.values[ids] = codes[inv.reshape(-1)]
        else:
            self.values[ids] = np.asarray(raw, self.values.dtype)
        self.present[ids] = True

    def clear_rows(self, ids: np.ndarray) -> None:
        ids = ids[ids < self.present.shape[0]]
        self.present[ids] = False

    def view(self, n: int):
        """(values, present) over id space [0, n), absent rows padded."""
        m = min(n, self.values.shape[0])
        values = np.zeros((n,), self.values.dtype)
        present = np.zeros((n,), np.bool_)
        values[:m] = self.values[:m]
        present[:m] = self.present[:m]
        return values, present


class MetadataStore:
    """Columnar metadata over the engine id space (module docstring)."""

    def __init__(self):
        self.cols: Dict[str, Column] = {}

    def __len__(self) -> int:
        return len(self.cols)

    @property
    def empty(self) -> bool:
        return not self.cols

    # ------------------------------------------------------------ writes
    @staticmethod
    def _columns(n: int, meta) -> Dict[str, Sequence]:
        """Row dicts or a columnar dict -> {column: values} aligned to n
        ids (numpy columns kept as arrays); missing keys become None."""
        if isinstance(meta, dict):
            cols = {}
            for name, vals in meta.items():
                vals = (vals.reshape(-1) if isinstance(vals, np.ndarray)
                        else list(vals))
                if len(vals) != n:
                    raise ValueError(
                        f"meta column {name!r} has {len(vals)} values "
                        f"for {n} ids")
                cols[name] = vals
            return cols
        rows = list(meta)
        if len(rows) != n:
            raise ValueError(f"{len(rows)} meta rows for {n} ids")
        names = set()
        for r in rows:
            names.update(r.keys())
        return {name: [r.get(name) for r in rows] for name in sorted(names)}

    @classmethod
    def normalize(cls, ids, meta) -> Dict[str, list]:
        """Row dicts or a columnar dict -> one columnar dict of lists
        aligned to ``ids`` (the WAL form; JSON-serializable, numpy columns
        as Python scalars). Missing keys become None (absent)."""
        return {name: _json_list(vals)
                for name, vals in cls._columns(len(ids), meta).items()}

    def put(self, ids, meta, *, replace: bool = False) -> Dict[str, list]:
        """Attach metadata for ``ids``. ``replace=True`` (upsert) first
        clears every column at those ids, so that stale fields do not
        linger. Returns the normalized columnar dict (the WAL form)."""
        ids = _host(ids).astype(np.int64).reshape(-1)
        cols = self._columns(len(ids), meta)
        if replace:
            self.delete(ids)
        for name, vals in cols.items():
            col = self.cols.get(name)
            if col is None:
                kind = self._new_kind(vals)
                if kind is None:
                    continue  # an all-None column: nothing to store
                col = self.cols[name] = Column(kind)
            col.set_rows(ids, vals)
        return {name: _json_list(vals) for name, vals in cols.items()}

    @staticmethod
    def _new_kind(vals) -> Optional[str]:
        """A new column's kind: its first value's, but float where an int
        column would also hold floats (the reference's rule)."""
        if isinstance(vals, np.ndarray) and vals.dtype.kind in _ARRAY_KINDS:
            return _ARRAY_KINDS[vals.dtype.kind] if vals.size else None
        for v in vals:
            if v is not None:
                kind = _kind_of(v)
                if kind == "int" and any(
                        isinstance(x, (float, np.floating))
                        and not isinstance(x, (bool, np.bool_))
                        for x in vals if x is not None):
                    kind = "float"
                return kind
        return None

    def delete(self, ids) -> None:
        ids = _host(ids).astype(np.int64).reshape(-1)
        ids = ids[ids >= 0]
        for col in self.cols.values():
            col.clear_rows(ids)

    # ------------------------------------------------------- evaluation
    def mask(self, pred: "Predicate", n: int) -> np.ndarray:
        """Evaluate ``pred`` over id space [0, n) -> (n,) bool bitmap."""
        return pred.mask(self, n)

    # ------------------------------------------------------ persistence
    def state_leaves(self) -> Dict[str, np.ndarray]:
        """Snapshot leaves (merged into the engine's state_dict). Leaves
        are arrays, so the schema and each vocabulary are uint8 JSON
        bytes."""
        leaves = {}
        schema = {}
        for name, col in self.cols.items():
            n = int(col.present.shape[0])
            schema[name] = {"kind": col.kind, "n": n}
            leaves[f"{STATE_PREFIX}{name}__values"] = col.values[:n].copy()
            leaves[f"{STATE_PREFIX}{name}__present"] = col.present[:n].copy()
            if col.kind == "cat":
                leaves[f"{STATE_PREFIX}{name}__vocab"] = np.frombuffer(
                    json.dumps(col.rev).encode(), np.uint8).copy()
        if schema:
            leaves[f"{STATE_PREFIX}schema"] = np.frombuffer(
                json.dumps(schema, sort_keys=True).encode(), np.uint8).copy()
        return leaves

    @classmethod
    def from_leaves(cls, arrays: dict) -> "MetadataStore":
        """Rebuild from (and pop) the ``metastore__*`` leaves of a loaded
        snapshot (arrays or tensors on any device). No leaves: an empty
        store."""
        store = cls()
        key = f"{STATE_PREFIX}schema"
        if key not in arrays:
            return store
        schema = json.loads(bytes(_host(arrays.pop(key)).astype(np.uint8)))
        for name, info in schema.items():
            col = Column(info["kind"])
            vals = _host(arrays.pop(f"{STATE_PREFIX}{name}__values"))
            pres = _host(arrays.pop(f"{STATE_PREFIX}{name}__present"))
            col.values = vals.astype(_DTYPES[col.kind]).reshape(-1).copy()
            col.present = pres.astype(np.bool_).reshape(-1).copy()
            if col.kind == "cat":
                col.rev = json.loads(bytes(_host(arrays.pop(
                    f"{STATE_PREFIX}{name}__vocab")).astype(np.uint8)))
                col.vocab = {v: i for i, v in enumerate(col.rev)}
            store.cols[name] = col
        return store


# --------------------------------------------------------------- predicates
class Predicate:
    """Base AST node. Subclasses implement mask() and key()."""

    def mask(self, store: MetadataStore, n: int) -> np.ndarray:
        raise NotImplementedError

    def key(self) -> tuple:
        raise NotImplementedError

    def __and__(self, other: "Predicate") -> "And":
        return And(self, other)

    def __or__(self, other: "Predicate") -> "Or":
        return Or(self, other)

    def __invert__(self) -> "Not":
        return Not(self)

    def __repr__(self):
        return f"{type(self).__name__}{self.key()[1:]}"


def _column_view(store: MetadataStore, name: str, n: int):
    col = store.cols.get(name)
    if col is None:
        return None, np.zeros((n,), _DTYPES["int"]), np.zeros((n,), np.bool_)
    values, present = col.view(n)
    return col, values, present


class Eq(Predicate):
    def __init__(self, column: str, value):
        self.column = column
        self.value = value

    def mask(self, store, n):
        col, values, present = _column_view(store, self.column, n)
        if col is None:
            return np.zeros((n,), np.bool_)
        if col.kind == "cat":
            if not isinstance(self.value, str):
                return np.zeros((n,), np.bool_)
            code = col.vocab.get(self.value)
            if code is None:
                return np.zeros((n,), np.bool_)
            return present & (values == code)
        try:
            return present & (values == values.dtype.type(self.value))
        except (TypeError, ValueError):
            return np.zeros((n,), np.bool_)

    def key(self):
        return ("eq", self.column, repr(self.value))


class Range(Predicate):
    """lo <= value <= hi (inclusive; None = unbounded). Numeric columns
    only — Range over a categorical/bool column raises."""

    def __init__(self, column: str, lo=None, hi=None):
        self.column = column
        self.lo = lo
        self.hi = hi

    def mask(self, store, n):
        col, values, present = _column_view(store, self.column, n)
        if col is None:
            return np.zeros((n,), np.bool_)
        if col.kind not in ("int", "float"):
            raise TypeError(
                f"Range({self.column!r}) needs a numeric column, "
                f"found {col.kind!r}")
        out = present.copy()
        if self.lo is not None:
            out &= values >= self.lo
        if self.hi is not None:
            out &= values <= self.hi
        return out

    def key(self):
        return ("range", self.column, repr(self.lo), repr(self.hi))


class In(Predicate):
    def __init__(self, column: str, values: Iterable):
        self.column = column
        self.values = tuple(values)

    def mask(self, store, n):
        col, values, present = _column_view(store, self.column, n)
        if col is None:
            return np.zeros((n,), np.bool_)
        if col.kind == "cat":
            codes = [col.vocab[v] for v in self.values
                     if isinstance(v, str) and v in col.vocab]
            if not codes:
                return np.zeros((n,), np.bool_)
            return present & np.isin(values, codes)
        try:
            wanted = np.asarray(self.values, values.dtype)
        except (TypeError, ValueError):
            return np.zeros((n,), np.bool_)
        return present & np.isin(values, wanted)

    def key(self):
        return ("in", self.column, tuple(sorted(repr(v) for v in self.values)))


class And(Predicate):
    def __init__(self, *children: Predicate):
        self.children = children

    def mask(self, store, n):
        out = np.ones((n,), np.bool_)
        for c in self.children:
            out &= c.mask(store, n)
        return out

    def key(self):
        return ("and",) + tuple(c.key() for c in self.children)


class Or(Predicate):
    def __init__(self, *children: Predicate):
        self.children = children

    def mask(self, store, n):
        out = np.zeros((n,), np.bool_)
        for c in self.children:
            out |= c.mask(store, n)
        return out

    def key(self):
        return ("or",) + tuple(c.key() for c in self.children)


class Not(Predicate):
    def __init__(self, child: Predicate):
        self.child = child

    def mask(self, store, n):
        return ~self.child.mask(store, n)

    def key(self):
        return ("not", self.child.key())


def filter_hash(pred: Optional[Predicate]) -> int:
    """Stable small int for plan-ledger salting (None -> 0)."""
    if pred is None:
        return 0
    return zlib.crc32(json.dumps(pred.key()).encode())
