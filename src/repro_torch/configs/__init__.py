"""Architecture registry of the port: the dense ``yi_6b``, ``gemma_2b``,
``glm4_9b`` and ``gemma3_4b``, the hybrid ``zamba2_1p2b``, the moe
``granite_moe_3b_a800m`` and ``deepseek_v2_lite_16b`` (MLA) and the ssm
``mamba2_370m``, in the order of ``repro.configs``. The encdec and vlm
architectures follow with their model families (ROADMAP.md)."""
from __future__ import annotations

import importlib
from typing import List

from ..models.config import ModelConfig

ARCHITECTURES: List[str] = [
    "yi_6b",
    "gemma_2b",
    "glm4_9b",
    "gemma3_4b",
    "zamba2_1p2b",
    "granite_moe_3b_a800m",
    "deepseek_v2_lite_16b",
    "mamba2_370m",
]

_ALIASES = {
    "yi-6b": "yi_6b",
    "gemma-2b": "gemma_2b",
    "glm4-9b": "glm4_9b",
    "gemma3-4b": "gemma3_4b",
    "zamba2-1.2b": "zamba2_1p2b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "mamba2-370m": "mamba2_370m",
}


def canonical(name: str) -> str:
    return _ALIASES.get(name, name.replace("-", "_").replace(".", "p"))


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    canon = canonical(name)
    if canon not in ARCHITECTURES:
        raise KeyError(f"{name!r} is not ported yet (have {ARCHITECTURES})")
    mod = importlib.import_module(f".{canon}", __package__)
    return mod.smoke_config() if smoke else mod.config()

