"""AdamW over nested dicts of tensors (port of ``repro/optim/adamw.py``).

Same math as the reference: a global-norm clip over all gradients, f32
moments with bias correction, decoupled weight decay on every leaf (norm
weights included) and an int32 step count. The update is functional, like
the reference's: it returns new tensors and leaves its inputs untouched.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch

from ..tree import tree_flatten, tree_map, tree_unflatten


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def adamw_init(params) -> Dict[str, Any]:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    leaves = tree_flatten(params)[0]
    device = leaves[0].device if leaves else None
    return {
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


@torch.no_grad()
def adamw_update(params, grads, state, cfg: AdamWConfig) -> Tuple[Any, Dict[str, Any]]:
    step = state["step"] + 1
    flat_p, td = tree_flatten(params)
    flat_g = tree_flatten(grads)[0]
    flat_m = tree_flatten(state["m"])[0]
    flat_v = tree_flatten(state["v"])[0]

    gnorm_sq = torch.zeros((), dtype=torch.float32, device=step.device)
    for g in flat_g:  # leaf order, as the reference's tree_reduce
        gnorm_sq = gnorm_sq + torch.sum(torch.square(g.float()))
    gnorm = torch.sqrt(gnorm_sq)
    scale = torch.clamp(torch.full_like(gnorm, cfg.grad_clip) / torch.clamp(gnorm, min=1e-12), max=1.0)
    step_f = step.float()
    bc1 = 1 - torch.pow(torch.full_like(step_f, cfg.b1), step_f)
    bc2 = 1 - torch.pow(torch.full_like(step_f, cfg.b2), step_f)

    new_p, new_m, new_v = [], [], []
    for p, g, m, v in zip(flat_p, flat_g, flat_m, flat_v):
        g = g.float() * scale
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * torch.square(g)
        mh = m / bc1
        vh = v / bc2
        delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * p.float()
        new_p.append((p.float() - cfg.lr * delta).to(p.dtype))
        new_m.append(m)
        new_v.append(v)
    return tree_unflatten(td, new_p), {
        "m": tree_unflatten(td, new_m),
        "v": tree_unflatten(td, new_v),
        "step": step,
    }
