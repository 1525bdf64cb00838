"""Architecture registry of the port: ``get_config("<arch-id>")`` for every
config of the JAX package, and the tiny config of the main path."""
from __future__ import annotations

from repro_torch.configs import (deepseek_v3_671b, granite_3_2b,
                                 granite_moe_1b, hymba_1_5b, llama3_8b,
                                 mamba2_2_7b, musicgen_medium, phi3_mini_3_8b,
                                 phi3_vision_4_2b, qwen3_32b, tiny)
from repro_torch.configs.base import ModelConfig, effective_cache_len, kv_cache_specs

_MODULES = {
    "tiny": tiny,
    "qwen3-32b": qwen3_32b,
    "hymba-1.5b": hymba_1_5b,
    "phi3-mini-3.8b": phi3_mini_3_8b,
    "phi-3-vision-4.2b": phi3_vision_4_2b,
    "granite-moe-1b-a400m": granite_moe_1b,
    "llama3-8b": llama3_8b,
    "granite-3-2b": granite_3_2b,
    "musicgen-medium": musicgen_medium,
    "deepseek-v3-671b": deepseek_v3_671b,
    "mamba2-2.7b": mamba2_2_7b,
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; available: {sorted(_MODULES)}")
    return _MODULES[arch].config()


__all__ = ["ARCH_IDS", "ModelConfig", "effective_cache_len", "get_config",
           "kv_cache_specs"]
