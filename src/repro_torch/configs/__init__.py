"""Architecture registry (copy of ``src/repro/configs``' ``get_arch`` and
``ARCH_IDS``).

The port carries the ``CONFIG`` of the architectures its slices serve,
number for number. The reference's ``PLAN``/``MeshPlan`` (the multi-card
mesh of the sharded backend) belongs to the multi-card slice. Every other
id raises ``ValueError`` naming the slice of the port that brings it.
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ArchConfig

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

PORTED = ("glm4-9b", "qwen3-14b", "rwkv6-1.6b", "qwen2.5-32b", "gemma3-27b", "hymba-1.5b",
          "granite-moe-1b-a400m", "whisper-medium", "internvl2-26b")

# The slice of the port that brings each architecture still missing.
_LATER = {
    "mixtral-8x22b": "the multi-card slice of the port (about 141 B params)",
}


def get_arch(arch_id: str) -> ArchConfig:
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; choose from {ARCH_IDS}")
    if arch_id not in PORTED:
        raise ValueError(f"arch {arch_id!r} is not ported yet: it needs {_LATER[arch_id]}")
    mod = arch_id.replace("-", "_").replace(".", "_")
    return importlib.import_module(f"repro_torch.configs.{mod}").CONFIG
