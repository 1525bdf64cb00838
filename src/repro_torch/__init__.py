"""PipelineRL on PyTorch and CUDA: the port of the JAX package `repro`.

This package imports `torch`, never `jax`, and nothing of `repro`; its
tests hold each module against its JAX counterpart. Ported so far: the
serving path of the dense GQA decoder (the continuous-batching
`GenerationEngine` with in-flight weight updates) with hand-written
Hopper kernels for flash_decode, prefill_attention and flash_attention.
Entry points run on the card unless the caller passes `device="cpu"`.
"""
from repro_torch.configs import ModelConfig, get_config
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core.rollout import EngineConfig, GenerationEngine
from repro_torch.models.model import init_params

__all__ = ["EngineConfig", "GenerationEngine", "ModelConfig", "get_config",
           "init_params", "params_from_numpy", "params_to_numpy"]
