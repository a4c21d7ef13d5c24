"""Architecture config registry of the port: ``get_config("<arch-id>")``.

Holds the archs whose model families are ported (dense, RWKV-6, the
RecurrentGemma hybrid); the other archs of the JAX registry join with their
families.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig, MoEConfig

ARCH_IDS = [
    "qwen3_0_6b",
    "rwkv6_3b",
    "recurrentgemma_9b",
    "paper_150m",
    "bench_tiny",
]


def canonical(arch_id: str) -> str:
    a = arch_id.replace("-", "_").replace(".", "_")
    if a not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ARCH_IDS)}")
    return a


def get_config(arch_id: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{canonical(arch_id)}")
    return mod.CONFIG


__all__ = ["ARCH_IDS", "get_config", "canonical", "ModelConfig", "MoEConfig"]
