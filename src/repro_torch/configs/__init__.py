"""Assigned-architecture registry (copy of ``src/repro/configs``).

Every architecture from the assignment pool is a module exporting
``CONFIG: ArchConfig`` (exact published hyper-parameters, source cited) and
``PLAN: MeshPlan`` (how it factors the production mesh). Select with
``get_arch("<id>")`` or ``--arch <id>`` on the launchers.
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ArchConfig
from repro_torch.sharding.plan import MeshPlan

ARCH_IDS = (
    "internvl2-26b",
    "mixtral-8x22b",
    "whisper-medium",
    "glm4-9b",
    "qwen2.5-32b",
    "hymba-1.5b",
    "granite-moe-1b-a400m",
    "rwkv6-1.6b",
    "qwen3-14b",
    "gemma3-27b",
)

# Every architecture of the reference is ported.
PORTED = ARCH_IDS

# Input shapes from the assignment (see configs/shapes.py for specs).
SHAPE_IDS = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def _module(arch_id: str):
    mod = arch_id.replace("-", "_").replace(".", "_")
    return importlib.import_module(f"repro_torch.configs.{mod}")


def get_arch(arch_id: str) -> ArchConfig:
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; choose from {ARCH_IDS}")
    return _module(arch_id).CONFIG


def get_plan(arch_id: str) -> MeshPlan:
    return _module(arch_id).PLAN


def all_archs() -> dict[str, ArchConfig]:
    return {a: get_arch(a) for a in ARCH_IDS}
