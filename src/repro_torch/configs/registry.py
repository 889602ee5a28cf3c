"""Architecture registry: ``--arch <id>`` resolution (port of
``repro.configs.registry``).

Every arch id of the reference is listed with its family (``lm``,
``encoder``, ``gnn``, ``recsys``), with the port's config module of the
same name.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict

_MODULES = {
    "stablelm-1.6b": ("stablelm_1_6b", "lm"),
    "h2o-danube-1.8b": ("h2o_danube_1_8b", "lm"),
    "stablelm-3b": ("stablelm_3b", "lm"),
    "deepseek-v2-lite-16b": ("deepseek_v2_lite_16b", "lm"),
    "deepseek-v3-671b": ("deepseek_v3_671b", "lm"),
    "graphsage-reddit": ("graphsage_reddit", "gnn"),
    "sasrec": ("sasrec", "recsys"),
    "autoint": ("autoint", "recsys"),
    "deepfm": ("deepfm", "recsys"),
    "fm": ("fm", "recsys"),
    "thistle-sbert": ("thistle_sbert", "encoder"),
}

@dataclasses.dataclass(frozen=True)
class ArchEntry:
    arch_id: str
    family: str  # lm | encoder | gnn | recsys
    full: object
    smoke: object


_CACHE: Dict[str, ArchEntry] = {}


def family(arch_id: str) -> str:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; have {sorted(_MODULES)}")
    return _MODULES[arch_id][1]


def get_arch(arch_id: str) -> ArchEntry:
    fam = family(arch_id)
    if arch_id not in _CACHE:
        mod = importlib.import_module(
            f"repro_torch.configs.{_MODULES[arch_id][0]}")
        _CACHE[arch_id] = ArchEntry(arch_id, fam, mod.FULL, mod.SMOKE)
    return _CACHE[arch_id]


def get_config(arch_id: str, *, smoke: bool = False):
    e = get_arch(arch_id)
    return e.smoke if smoke else e.full


def list_archs():
    return sorted(_MODULES)


ASSIGNED = [a for a in _MODULES if a != "thistle-sbert"]
