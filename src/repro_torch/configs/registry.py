"""Arch-id → config registry (``--arch <id>`` in every launcher)."""

from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

_MODULES = {
    "mamba2-780m": "repro_torch.configs.mamba2_780m",
    "qwen2-vl-72b": "repro_torch.configs.qwen2_vl_72b",
    "jamba-1.5-large-398b": "repro_torch.configs.jamba_1_5_large_398b",
    "minicpm-2b": "repro_torch.configs.minicpm_2b",
    "minitron-4b": "repro_torch.configs.minitron_4b",
    "deepseek-coder-33b": "repro_torch.configs.deepseek_coder_33b",
    "mistral-nemo-12b": "repro_torch.configs.mistral_nemo_12b",
    "granite-moe-3b-a800m": "repro_torch.configs.granite_moe_3b_a800m",
    "phi3.5-moe-42b-a6.6b": "repro_torch.configs.phi3_5_moe_42b_a6_6b",
    "whisper-small": "repro_torch.configs.whisper_small",
}

ARCHS = tuple(_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[arch]).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return importlib.import_module(_MODULES[arch]).SMOKE


def get_schedule(arch: str) -> str:
    mod = importlib.import_module(_MODULES[arch])
    return getattr(mod, "SCHEDULE", "cosine")
