"""PipelineRL on PyTorch and CUDA: the port of the JAX package `repro`.

This package imports `torch`, never `jax`, and nothing of `repro`; its
tests hold each module against its JAX counterpart. Ported so far: the
serving path of the dense GQA decoder (the continuous-batching
`GenerationEngine` with in-flight weight updates, on the slot cache or the
paged cache with prefix-shared GRPO admission), the training path (`pack`,
`Preprocessor`, `Trainer` with the REINFORCE loss, Adam and the non-finite
guard) and the orchestration that drives them (`PipelineRL` on the event
loop, `ConventionalRL`, the `HardwareModel` clock, the request `Server`,
the `Evaluator` and the `FaultPlan` fault injection), for every
architecture of the JAX package (dense GQA, Mamba2, the Hymba hybrid, MoE,
DeepSeek-V3's latent attention and MTP head, the multimodal prefix), with
hand-written Hopper kernels for flash_decode, flash_decode_paged,
prefill_attention, flash_attention, the fused lm-head loss and the SSD
scan. Entry points run on the card unless the caller passes
`device="cpu"`.
"""
from repro_torch.configs import ModelConfig, get_config
from repro_torch.convert import (params_from_numpy, params_to_numpy,
                                 train_state_from_numpy, train_state_to_numpy)
from repro_torch.core.algo import RLConfig
from repro_torch.core.conventional import ConventionalConfig, ConventionalRL
from repro_torch.core.evaluator import Evaluator
from repro_torch.core.events import (
    ActorStage, EventLoop, Fault, FaultPlan, PoolRouter, PreprocessStage,
    TrainerStage, WeightBroadcaster,
)
from repro_torch.core.pipeline import PipelineConfig, PipelineRL
from repro_torch.core.preprocess import PreprocessConfig, Preprocessor
from repro_torch.core.rollout import EngineConfig, GenerationEngine
from repro_torch.core.serving import Request, Server
from repro_torch.core.sim import HardwareModel
from repro_torch.core.trainer import Trainer
from repro_torch.data.packing import pack
from repro_torch.models.model import init_params
from repro_torch.optim.adam import AdamConfig

__all__ = ["ActorStage", "AdamConfig", "ConventionalConfig", "ConventionalRL",
           "EngineConfig", "Evaluator", "EventLoop", "Fault", "FaultPlan",
           "GenerationEngine", "HardwareModel", "ModelConfig",
           "PipelineConfig", "PipelineRL", "PoolRouter", "PreprocessConfig",
           "PreprocessStage", "Preprocessor", "RLConfig", "Request", "Server",
           "Trainer", "TrainerStage", "WeightBroadcaster", "get_config",
           "init_params", "pack", "params_from_numpy", "params_to_numpy",
           "train_state_from_numpy", "train_state_to_numpy"]
