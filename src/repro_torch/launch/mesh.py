"""Device meshes and the hardware constants of the target card (port of
``repro/launch/mesh.py``).

A mesh is a ``torch.distributed`` ``DeviceMesh`` over the initialised
default process group, with the reference's axis names. Meshes are made by
functions, so importing this module touches no process group and no
device.
"""
from __future__ import annotations

from typing import Optional

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: Optional[str] = None) -> DeviceMesh:
    """Single pod: (data=16, model=16) = 256 ranks. Multi-pod: 2 pods = 512
    ranks with a pure-DP "pod" axis. Needs a process group of exactly that
    world size; ``device_type`` None means "cuda"."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type or "cuda", shape, mesh_dim_names=axes)


def make_host_mesh(model: int = 1, device_type: Optional[str] = None) -> DeviceMesh:
    """A ("data", "model") mesh of shape (world // model, model) over the
    initialised process group; ``device_type`` None means "cuda"."""
    n = dist.get_world_size()
    if n % model:
        raise ValueError(f"model={model} does not divide the world size {n}")
    return init_device_mesh(device_type or "cuda", (n // model, model),
                            mesh_dim_names=("data", "model"))


#: NVIDIA H100 SXM5 80GB, per card, from NVIDIA's H100 Tensor Core GPU data
#: sheet (SXM column; dense rates, without sparsity; at its 700 W maximum
#: power): the roofline's and the memory model's constants.
H100_SXM = {
    "peak_flops_bf16": 989e12,   # FLOP/s, BF16 tensor core
    "peak_flops_f32": 67e12,     # FLOP/s, FP32 outside the tensor cores
    "hbm_bw": 3.35e12,           # B/s, HBM3
    "nvlink_bw": 900e9,          # B/s, NVLink 4, all links of one card
    "hbm_bytes": 80e9,           # B, 80 GB of HBM3
}
