"""Config registry: ``get_config(arch_id)`` / ``list_archs()``.

Each architecture the port carries has its own module defining ``CONFIG``,
a copy of the reference's module of the same name. Registered: all ten
of the reference's architectures, of every family: dense, MoE, SSM,
hybrid (jamba), VLM (llava) and audio (whisper).
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (GAConfig, ModelConfig, ShapeConfig,
                                      SHAPES, shape_applicable)

# arch-id -> module name
_ARCH_MODULES = {
    "gemma2-2b":            "gemma2_2b",
    "granite-8b":           "granite_8b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "llava-next-34b":       "llava_next_34b",
    "mamba2-780m":          "mamba2_780m",
    "minicpm-2b":           "minicpm_2b",
    "qwen2-moe-a2.7b":      "qwen2_moe_a2_7b",
    "tinyllama-1.1b":       "tinyllama_1_1b",
    "whisper-large-v3":     "whisper_large_v3",
}


def list_archs() -> list[str]:
    return sorted(_ARCH_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {list_archs()}")
    mod = importlib.import_module(
        f"repro_torch.configs.{_ARCH_MODULES[arch]}")
    return mod.CONFIG


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


__all__ = ["GAConfig", "ModelConfig", "ShapeConfig", "SHAPES",
           "get_config", "get_shape", "list_archs", "shape_applicable"]
