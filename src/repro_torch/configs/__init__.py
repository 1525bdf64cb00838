"""Architecture registry of the port: ``get_config("<arch-id>")`` for the
dense GQA and Mamba2 configs ported so far."""
from __future__ import annotations

from repro_torch.configs import granite_3_2b, llama3_8b, mamba2_2_7b, tiny
from repro_torch.configs.base import ModelConfig, effective_cache_len, kv_cache_specs

_MODULES = {
    "tiny": tiny,
    "llama3-8b": llama3_8b,
    "granite-3-2b": granite_3_2b,
    "mamba2-2.7b": mamba2_2_7b,
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; available: {sorted(_MODULES)}")
    return _MODULES[arch].config()


__all__ = ["ARCH_IDS", "ModelConfig", "effective_cache_len", "get_config",
           "kv_cache_specs"]
