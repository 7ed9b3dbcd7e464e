"""Assigned architecture configs (+ reduced smoke configs).

``get_config(arch_id)`` / ``get_smoke_config(arch_id)`` resolve by the
public architecture id (e.g. ``"llama3-8b"``). The arch files are copies
of ``repro.configs``'s, pinned field for field by
``tests/test_torch_core.py``.
"""

from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

_MODULES: dict[str, str] = {
    "starcoder2-3b": "starcoder2_3b",
    "yi-6b": "yi_6b",
    "h2o-danube-1.8b": "h2o_danube_1_8b",
    "llama3-8b": "llama3_8b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "qwen2-vl-7b": "qwen2_vl_7b",
    "mamba2-2.7b": "mamba2_2_7b",
    "whisper-tiny": "whisper_tiny",
}

ARCHS: tuple[str, ...] = tuple(_MODULES)


def _load(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; have {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _load(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _load(arch).SMOKE_CONFIG


__all__ = ["ARCHS", "get_config", "get_smoke_config"]
