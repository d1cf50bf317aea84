"""Architecture registry of the port: ``gemma_2b`` (dense) and
``mamba2_370m`` (ssm). The other architectures of ``repro.configs`` follow
with their model families (ROADMAP.md)."""
from __future__ import annotations

import importlib
from typing import List

from ..models.config import ModelConfig

ARCHITECTURES: List[str] = ["gemma_2b", "mamba2_370m"]

_ALIASES = {"gemma-2b": "gemma_2b", "mamba2-370m": "mamba2_370m"}


def canonical(name: str) -> str:
    return _ALIASES.get(name, name.replace("-", "_").replace(".", "p"))


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    canon = canonical(name)
    if canon not in ARCHITECTURES:
        raise KeyError(f"{name!r} is not ported yet (have {ARCHITECTURES})")
    mod = importlib.import_module(f".{canon}", __package__)
    return mod.smoke_config() if smoke else mod.config()

