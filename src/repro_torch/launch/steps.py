"""Train-step builder (port of ``repro/launch/steps.py::make_train_step``).

One optimizer step: forward, mean next-token loss, gradients by autograd,
then AdamW. The reference's tuning flags (``loss_chunk``, ``microbatch``) are
off by default there and not ported yet, and remat has no counterpart:
autograd keeps every activation, as remat ``"none"`` does.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ..models.config import ModelConfig
from ..models.transformer import forward_dense, lm_loss
from ..optim import AdamWConfig, adamw_update
from ..tree import tree_flatten, tree_unflatten


def make_train_step(cfg: ModelConfig, opt_cfg: Optional[AdamWConfig] = None):
    opt_cfg = opt_cfg or AdamWConfig()

    def train_step(params, opt_state, batch: Dict):
        """(params, opt_state, {"tokens": (B, S+1) int}) ->
        (new params, new opt_state, loss as a 0-d f32 tensor)."""
        leaves, td = tree_flatten(params)
        leaves = [p.detach().requires_grad_(True) for p in leaves]
        tree = tree_unflatten(td, leaves)
        dev = leaves[0].device
        tokens = torch.as_tensor(batch["tokens"], device=dev)
        with torch.enable_grad():
            logits = forward_dense(cfg, tree, tokens[:, :-1])
            loss = lm_loss(cfg, logits, tokens[:, 1:])
            grads = torch.autograd.grad(loss, leaves)
        new_params, new_opt = adamw_update(
            tree_unflatten(td, [p.detach() for p in leaves]),
            tree_unflatten(td, list(grads)), opt_state, opt_cfg,
        )
        return new_params, new_opt, loss.detach()

    return train_step
