"""Architecture registry of the port: every architecture of
``repro.configs``, in its order: the encdec ``seamless_m4t_large_v2``, the
dense ``yi_6b``, ``gemma_2b``, ``glm4_9b`` and ``gemma3_4b``, the hybrid
``zamba2_1p2b``, the moe ``granite_moe_3b_a800m`` and
``deepseek_v2_lite_16b`` (MLA), the ssm ``mamba2_370m`` and the vlm
``llama_3p2_vision_90b``."""
from __future__ import annotations

import importlib
from typing import List

from ..models.config import ModelConfig

ARCHITECTURES: List[str] = [
    "seamless_m4t_large_v2",
    "yi_6b",
    "gemma_2b",
    "glm4_9b",
    "gemma3_4b",
    "zamba2_1p2b",
    "granite_moe_3b_a800m",
    "deepseek_v2_lite_16b",
    "mamba2_370m",
    "llama_3p2_vision_90b",
]

_ALIASES = {
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "yi-6b": "yi_6b",
    "gemma-2b": "gemma_2b",
    "glm4-9b": "glm4_9b",
    "gemma3-4b": "gemma3_4b",
    "zamba2-1.2b": "zamba2_1p2b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "mamba2-370m": "mamba2_370m",
    "llama-3.2-vision-90b": "llama_3p2_vision_90b",
}


def canonical(name: str) -> str:
    return _ALIASES.get(name, name.replace("-", "_").replace(".", "p"))


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    canon = canonical(name)
    if canon not in ARCHITECTURES:
        raise KeyError(f"{name!r} is not an architecture of the registry (have {ARCHITECTURES})")
    mod = importlib.import_module(f".{canon}", __package__)
    return mod.smoke_config() if smoke else mod.config()

