"""Architecture configs: the dense, MoE and VLM ones of ``repro/configs``,
copied verbatim, in the JAX dict's order (the hybrid, RWKV and enc-dec
families wait for their slices)."""

from importlib import import_module
from typing import List

from ..models.api import ModelConfig

_MODULES = {
    "starcoder2-15b": "starcoder2_15b",
    "glm4-9b": "glm4_9b",
    "qwen2-1.5b": "qwen2_1_5b",
    "granite-34b": "granite_34b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "mixtral-8x7b": "mixtral_8x7b",
    "qwen2-vl-7b": "qwen2_vl_7b",
}

ARCH_IDS: List[str] = list(_MODULES)


def get_config(arch: str) -> ModelConfig:
    return import_module(f".{_MODULES[arch]}", __package__).CONFIG


def get_reduced(arch: str) -> ModelConfig:
    return import_module(f".{_MODULES[arch]}", __package__).REDUCED
