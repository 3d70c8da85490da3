"""Architecture registry: ``--arch <id>`` resolves here.

Each module exports CONFIG (the exact assigned configuration) and SMOKE
(a reduced same-family configuration for CPU tests), as in
``repro.configs``.  The port carries the seven configurations whose
pattern has no MoE sub-layer; the three MoE architectures wait for the
slice that ports ``models/moe.py`` and raise ``NotImplementedError``.
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

__all__ = ["ARCH_IDS", "MOE_ARCH_IDS", "get_config", "get_smoke_config"]

ARCH_IDS = (
    "llava-next-34b",
    "musicgen-large",
    "falcon-mamba-7b",
    "qwen2-1.5b",
    "h2o-danube-1.8b",
    "qwen1.5-0.5b",
    "qwen3-0.6b",
)
MOE_ARCH_IDS = (
    "moonshot-v1-16b-a3b",
    "qwen3-moe-235b-a22b",
    "jamba-1.5-large-398b",
)


def _module(arch_id: str):
    if arch_id in MOE_ARCH_IDS:
        raise NotImplementedError(
            f"{arch_id} has MoE sub-layers; the port's MoE slice "
            "(models/moe.py) is not written yet")
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    return importlib.import_module(
        "repro_torch.configs." + arch_id.replace("-", "_").replace(".", "_"))


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).SMOKE
