"""Architecture registry: the 10 assigned backbones, a copy of
``repro.configs`` (plain data, no JAX).

``get_config(arch_id)`` returns the full published config;
``get_smoke_config(arch_id)`` returns a reduced same-family config for CPU
smoke tests (small layers/width, few experts, tiny vocab).
"""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.config import ModelConfig

ARCH_IDS = [
    "falcon_mamba_7b",
    "command_r_plus_104b",
    "deepseek_7b",
    "phi3_medium_14b",
    "yi_6b",
    "zamba2_2p7b",
    "qwen2_vl_72b",
    "phi3p5_moe_42b",
    "qwen3_moe_30b",
    "whisper_tiny",
]

# Accept dashed ids from the assignment table too.
_ALIASES = {
    "falcon-mamba-7b": "falcon_mamba_7b",
    "command-r-plus-104b": "command_r_plus_104b",
    "deepseek-7b": "deepseek_7b",
    "phi3-medium-14b": "phi3_medium_14b",
    "yi-6b": "yi_6b",
    "zamba2-2.7b": "zamba2_2p7b",
    "qwen2-vl-72b": "qwen2_vl_72b",
    "phi3.5-moe-42b-a6.6b": "phi3p5_moe_42b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b",
    "whisper-tiny": "whisper_tiny",
}


def canonical(arch_id: str) -> str:
    return _ALIASES.get(arch_id, arch_id)


def get_config(arch_id: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{canonical(arch_id)}")
    return mod.CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{canonical(arch_id)}")
    return mod.SMOKE_CONFIG


def all_configs() -> dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
