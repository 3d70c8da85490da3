"""Architecture registry: ``--arch <id>`` resolves here.

Each module exports CONFIG (the exact assigned configuration) and SMOKE
(a reduced same-family configuration for CPU tests), as in
``repro.configs``; the ten architectures, the four input-shape cells
and their applicability are JAX's.
"""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.config import ModelConfig

__all__ = ["ARCH_IDS", "ShapeSpec", "SHAPES", "get_config",
           "get_smoke_config", "shape_applicable", "all_cells"]

ARCH_IDS = (
    "llava-next-34b",
    "moonshot-v1-16b-a3b",
    "qwen3-moe-235b-a22b",
    "jamba-1.5-large-398b",
    "musicgen-large",
    "falcon-mamba-7b",
    "qwen2-1.5b",
    "h2o-danube-1.8b",
    "qwen1.5-0.5b",
    "qwen3-0.6b",
)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def _module(arch_id: str):
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    return importlib.import_module(
        "repro_torch.configs." + arch_id.replace("-", "_").replace(".", "_"))


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).SMOKE


def shape_applicable(cfg: ModelConfig, shape_name: str) -> bool:
    """long_500k requires a sub-quadratic arch (SSM/hybrid/SWA)."""
    if shape_name == "long_500k":
        return cfg.sub_quadratic
    return True


def all_cells():
    """Every (arch, shape, applicable) triple: the 40-cell accounting,
    documented skips included."""
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape in SHAPES:
            yield arch, shape, shape_applicable(cfg, shape)
