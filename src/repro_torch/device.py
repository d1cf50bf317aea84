"""Device selection shared by the port's entry points."""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means the card. A CUDA device that is not there raises: the
    CPU is used only when the caller asks for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA was requested but torch.cuda.is_available() is False; "
                           "pass device='cpu' to run on the CPU")
    return dev
