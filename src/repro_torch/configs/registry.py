"""Architecture registry: ``--arch <id>`` resolution (port of
``repro.configs.registry``).

Every arch id of the reference is listed with its family. The port has
config modules for the encoder family (``thistle-sbert``) and the five
``lm`` archs; ``get_arch`` of a ``gnn`` or ``recsys`` id raises
``NotImplementedError`` naming the ROADMAP item that brings its configs
and models.
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

PORTED_FAMILIES = ("encoder", "lm")
# where each family's configs and models come (ROADMAP.md Queue 1)
PENDING = {"gnn": "ROADMAP.md Queue 1, item 9 (models/gnn.py)",
           "recsys": "ROADMAP.md Queue 1, item 9 (models/recsys.py)"}


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
    if fam not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"{arch_id!r} is of the {fam} family, whose configs and models "
            f"the port does not have yet: {PENDING[fam]}")
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
