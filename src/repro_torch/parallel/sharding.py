"""Sharding profiles: logical-axis -> mesh-axis rules per (arch x shape)
(port of ``repro/parallel/sharding.py``).

The rules are the reference's:
  * DP: batch over ("pod", "data"), pods a pure-DP outer axis;
  * TP: heads / kv_heads / ffn / vocab / experts over "model";
  * FSDP (2D): for params too large to replicate per data shard, the
    "embed" dim of every weight also shards over "data";
  * the decode/prefill fallback: when kv_heads cannot divide "model", the
    cache's sequence dim shards over "model";
  * EP: MoE experts over "model" when divisible, else expert_ffn.

A mesh is a ``DeviceMesh`` (``launch/mesh.py``); the rules read only its
``mesh_dim_names`` and ``shape``. ``tree_shardings`` gives each leaf its
DTensor placements, the counterpart of the reference's ``NamedSharding``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch
from torch.distributed.tensor import Replicate, Shard

from ..models.config import ModelConfig, ShapeConfig
from ..models.params import PDesc, resolve_spec
from ..tree import tree_map


@dataclass(frozen=True)
class ShardingProfile:
    name: str
    rules: Dict[str, Tuple[str, ...]]


def _batch_axes(mesh) -> Tuple[str, ...]:
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)


def make_rules(mesh, *, kind: str, fsdp: bool = False) -> ShardingProfile:
    batch = _batch_axes(mesh)
    rules: Dict[str, Tuple[str, ...]] = {
        "batch": batch,
        "vocab": ("model",),
        "heads": ("model",),
        "kv_heads": ("model",),
        "ffn": ("model",),
        "experts": ("model",),
        "expert_ffn": ("model",),   # fallback when experts % model != 0
    }
    if fsdp:
        rules["embed"] = ("data",)  # 2D: TP x FSDP
    if kind in ("decode", "prefill"):
        rules["seq"] = ("model",)   # fallback when kv_heads can't shard (MQA)
    name = f"{kind}{'_fsdp' if fsdp else ''}"
    return ShardingProfile(name, rules)


#: archs whose params+optimizer do not fit replicated-per-data-shard.
_FSDP_REQUIRED = {"llama-3.2-vision-90b"}
#: archs large enough that FSDP is the sensible default even if not forced.
_FSDP_PREFERRED = {"glm4-9b", "deepseek-v2-lite-16b", "yi-6b"}


def profile_for(cfg: ModelConfig, shape: ShapeConfig, mesh) -> ShardingProfile:
    fsdp = shape.kind == "train" and (
        cfg.name in _FSDP_REQUIRED or cfg.name in _FSDP_PREFERRED
    )
    return make_rules(mesh, kind=shape.kind, fsdp=fsdp)


def mesh_axis_sizes(mesh) -> Dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def placements(spec: tuple, mesh) -> tuple:
    """One spec -> its DTensor placements on ``mesh``: per mesh dim,
    ``Shard(d)`` for the tensor dim ``d`` whose entry names that mesh axis,
    else ``Replicate()``. An entry naming several mesh axes, such as a batch
    dim over ("pod", "data"), splits its dim over them major to minor, first
    axis outermost; DTensor splits a dim that several mesh dims shard in
    the order of the mesh dims, so the entry's axes must come in the mesh's
    own order (the reference's rules only ever give ("pod", "data"))."""
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        where = [names.index(a) for a in axes]
        if where != sorted(where):
            raise ValueError(f"spec entry {axes} is not in the mesh's axis order {names}")
        for i in where:
            out[i] = Shard(dim)
    return tuple(out)


def tree_shardings(descs, profile: ShardingProfile, mesh):
    """PDesc tree -> a tree of DTensor placement tuples on ``mesh``. Read it
    by the descriptor tree's keys (its leaves are tuples)."""
    sizes = mesh_axis_sizes(mesh)
    return tree_map(lambda d: placements(resolve_spec(d, profile.rules, sizes), mesh), descs)


# --------------------------------------------------------------------------- #
# model inputs as descriptor trees                                             #
# --------------------------------------------------------------------------- #
def batch_input_descs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, PDesc]:
    """Descriptor tree for one step's inputs (tokens + stub modality)."""
    B = shape.global_batch
    if shape.kind == "train":
        descs = {"tokens": PDesc((B, shape.seq_len + 1), ("batch", "seq"))}
    elif shape.kind == "prefill":
        descs = {"tokens": PDesc((B, shape.seq_len), ("batch", "seq"))}
    else:  # decode: one new token against a seq_len-deep cache
        descs = {"tokens": PDesc((B, 1), ("batch", None))}
    if cfg.family == "encdec":
        descs["frames"] = PDesc((B, cfg.source_len, cfg.d_model), ("batch", None, None))
    if cfg.family == "vlm":
        descs["image_embeds"] = PDesc(
            (B, cfg.num_image_tokens, cfg.d_model), ("batch", None, None)
        )
    return descs


def batch_dtypes(cfg: ModelConfig) -> Dict[str, torch.dtype]:
    out = {"tokens": torch.int32}
    if cfg.family == "encdec":
        out["frames"] = torch.bfloat16
    if cfg.family == "vlm":
        out["image_embeds"] = torch.bfloat16
    return out
