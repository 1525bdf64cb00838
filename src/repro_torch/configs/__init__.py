"""Architecture registry of the port: ``get_config("<arch-id>")`` for every
config of the JAX package, the tiny config of the main path, and the
port's own configs (`PORT_ONLY`), which the JAX package lacks."""
from __future__ import annotations

from typing import Dict

from repro_torch.configs import (deepseek_v3_671b, granite_3_2b,
                                 granite_4_0_h_micro, granite_moe_1b,
                                 hymba_1_5b, llama3_8b,
                                 mamba2_2_7b, musicgen_medium, phi3_mini_3_8b,
                                 phi3_vision_4_2b, qwen3_32b, tiny)
from repro_torch.configs.base import (SHAPES, ModelConfig, ShapeSpec,
                                     effective_cache_len, for_shape,
                                     input_specs, kv_cache_specs,
                                     smoke_config)

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
    "granite-4.0-h-micro": granite_4_0_h_micro,
}

ARCH_IDS = tuple(_MODULES)
# configs the JAX package has no twin of
PORT_ONLY = ("granite-4.0-h-micro",)


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; available: {sorted(_MODULES)}")
    return _MODULES[arch].config()


def all_configs() -> Dict[str, ModelConfig]:
    """Every config of the JAX package's registry (the tiny config of the
    main path and the port's own configs are left out, as that registry
    has none)."""
    return {k: get_config(k) for k in ARCH_IDS
            if k != "tiny" and k not in PORT_ONLY}


__all__ = ["ARCH_IDS", "PORT_ONLY", "SHAPES", "ModelConfig", "ShapeSpec",
           "all_configs", "effective_cache_len", "for_shape", "get_config",
           "input_specs", "kv_cache_specs", "smoke_config"]
