"""Architecture registry of the port: the dense ``yi_6b``, ``gemma_2b``,
``glm4_9b`` and ``gemma3_4b`` and the ssm ``mamba2_370m``, in the order of
``repro.configs``. The other architectures follow with their model families
(ROADMAP.md)."""
from __future__ import annotations

import importlib
from typing import List

from ..models.config import ModelConfig

ARCHITECTURES: List[str] = ["yi_6b", "gemma_2b", "glm4_9b", "gemma3_4b", "mamba2_370m"]

_ALIASES = {
    "yi-6b": "yi_6b",
    "gemma-2b": "gemma_2b",
    "glm4-9b": "glm4_9b",
    "gemma3-4b": "gemma3_4b",
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

