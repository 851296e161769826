"""Architecture registry: --arch <id> resolves here."""
from importlib import import_module
from typing import Dict

from .base import ModelConfig, ShapeConfig, lm_shapes

_ARCH_MODULES: Dict[str, str] = {
    "falcon-mamba-7b": ".falcon_mamba_7b",
    "grok-1-314b": ".grok1_314b",
    "mixtral-8x7b": ".mixtral_8x7b",
    "qwen2.5-32b": ".qwen25_32b",
    "granite-20b": ".granite_20b",
    "stablelm-3b": ".stablelm_3b",
    "qwen2-72b": ".qwen2_72b",
    "jamba-1.5-large-398b": ".jamba15_large_398b",
    "hubert-xlarge": ".hubert_xlarge",
    "llama-3.2-vision-11b": ".llama32_vision_11b",
}

ARCH_IDS = list(_ARCH_MODULES.keys())


def get_arch(arch_id: str):
    """Returns the arch module with CONFIG / SMOKE_CONFIG / SHAPES."""
    if arch_id not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    return import_module(_ARCH_MODULES[arch_id], __package__)


def get_config(arch_id: str, smoke: bool = False) -> ModelConfig:
    mod = get_arch(arch_id)
    return mod.SMOKE_CONFIG if smoke else mod.CONFIG


def get_shapes(arch_id: str) -> Dict[str, ShapeConfig]:
    return dict(get_arch(arch_id).SHAPES)


def all_cells():
    """Every (arch, shape) dry-run cell after principled skips."""
    for arch_id in ARCH_IDS:
        for shape_name, shape in get_shapes(arch_id).items():
            yield arch_id, shape_name, shape


__all__ = ["ModelConfig", "ShapeConfig", "lm_shapes", "ARCH_IDS",
           "get_arch", "get_config", "get_shapes", "all_cells"]
