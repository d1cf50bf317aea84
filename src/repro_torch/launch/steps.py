"""Step-function builders (port of ``repro/launch/steps.py``).

``train_step`` is one optimizer step: forward, mean next-token loss plus
the forward's MoE aux loss, gradients by autograd (zero for a leaf the
forward does not reach, as ``jax.grad`` gives), then AdamW.
``prefill_step`` runs the full-sequence forward and emits the last token's
logits. ``serve_step`` decodes one token against an explicit KV/state
cache, updated in place. The tuning flags
``loss_chunk`` and ``microbatch`` are read from ``models.tuning`` when a
train step runs, as in the reference. A batch is ``{"tokens": ...}`` and
the family's extras (the encdec ``"frames"``, the vlm ``"image_embeds"``),
arrays or tensors, which each step moves to the parameters' device; the
microbatches slice the extras by rows as they slice the tokens.

A train step records the recorder's (``obs``) spans ``train_step`` (entry
to return: every launch enqueued, no wait for the device) and its phases
``step.h2d``, ``step.forward`` (forward and loss), ``step.backward``
(gradients, the zero ones and a microbatch's accumulation) and
``step.optimizer`` (AdamW), so that a device trace can say which phase
launched what.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from .. import obs
from ..models.config import ModelConfig
from ..models.transformer import chunked_lm_loss, decode_step, forward, lm_loss
from ..models.tuning import get_tuning
from ..optim import AdamWConfig, adamw_update
from ..tree import tree_flatten, tree_unflatten

F32 = torch.float32


def split_batch(batch: Dict) -> Tuple[object, Dict]:
    extras = {k: v for k, v in batch.items() if k not in ("tokens",)}
    return batch["tokens"], extras


def _device(params) -> torch.device:
    return tree_flatten(params)[0][0].device


def _on(dev: torch.device, batch: Dict) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The batch's tokens and extras as tensors on ``dev``."""
    tokens, extras = split_batch(batch)
    return (torch.as_tensor(tokens, device=dev),
            {k: torch.as_tensor(v, device=dev) for k, v in extras.items()})


def make_train_step(cfg: ModelConfig, opt_cfg: Optional[AdamWConfig] = None,
                    remat: str = "full"):
    opt_cfg = opt_cfg or AdamWConfig()

    def train_step(params, opt_state, batch: Dict):
        """(params, opt_state, {"tokens": (B, S+1) int, extras}) ->
        (new params, new opt_state, loss as a 0-d f32 tensor)."""
        with obs.span("train_step"):
            return _train_step(params, opt_state, batch)

    def _train_step(params, opt_state, batch: Dict):
        tun = get_tuning()
        leaves, td = tree_flatten(params)
        leaves = [p.detach().requires_grad_(True) for p in leaves]
        tree = tree_unflatten(td, leaves)
        dev = leaves[0].device
        with obs.span("step.h2d"):
            tokens, extras = _on(dev, batch)

        def value_and_grad(tok, ext):
            with torch.enable_grad():
                with obs.span("step.forward"):
                    out, _, aux = forward(cfg, tree, tok[:, :-1], extras=ext, remat=remat)
                    if tun.loss_chunk:
                        loss = chunked_lm_loss(cfg, tree, out, tok[:, 1:], aux, tun.loss_chunk)
                    else:
                        loss = lm_loss(cfg, out, tok[:, 1:], aux)
                with obs.span("step.backward"):
                    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
                    # a leaf the forward does not reach (zamba2's shared block
                    # below its first site) has a zero gradient, as under jax.grad
                    grads = [torch.zeros_like(p) if g is None else g
                             for p, g in zip(leaves, grads)]
            return loss.detach(), grads

        mb = tun.microbatch
        if mb > 1 and tokens.shape[0] % mb == 0:
            # gradient accumulation: divides saved-activation memory by mb.
            # f32 gradients summed in microbatch order from zeros, then / mb
            n = tokens.shape[0] // mb
            with obs.span("step.backward"):
                gsum = [torch.zeros(p.shape, dtype=F32, device=dev) for p in leaves]
                lsum = torch.zeros((), dtype=F32, device=dev)
            for i in range(mb):
                rows = slice(i * n, (i + 1) * n)
                loss_mb, g = value_and_grad(tokens[rows], {k: v[rows] for k, v in extras.items()})
                with obs.span("step.backward"):
                    gsum = [a + b.to(F32) for a, b in zip(gsum, g)]
                    lsum = lsum + loss_mb
            with obs.span("step.backward"):
                grads = [g / mb for g in gsum]
                loss = lsum / mb
        else:
            loss, grads = value_and_grad(tokens, extras)
        with obs.span("step.optimizer"):
            new_params, new_opt = adamw_update(
                tree_unflatten(td, [p.detach() for p in leaves]),
                tree_unflatten(td, list(grads)), opt_state, opt_cfg,
            )
        return new_params, new_opt, loss

    return train_step


def make_prefill_step(cfg: ModelConfig):
    def prefill_step(params, batch: Dict) -> torch.Tensor:
        """{"tokens": (B, S) int, extras} -> the last position's logits (B, 1, vocab_padded)."""
        tokens, extras = _on(_device(params), batch)
        with torch.no_grad():
            return forward(cfg, params, tokens, extras=extras, last_only=True)[0]

    return prefill_step


def make_serve_step(cfg: ModelConfig):
    def serve_step(params, cache, batch: Dict, cache_index: int):
        """One token (B, 1) at ``cache_index`` -> (logits, the cache updated in place)."""
        tokens, extras = _on(_device(params), batch)
        with torch.no_grad():
            return decode_step(cfg, params, cache, tokens, cache_index, extras=extras)

    return serve_step


def make_step(cfg: ModelConfig, kind: str, remat: str = "full"):
    if kind == "train":
        return make_train_step(cfg, remat=remat)
    if kind == "prefill":
        return make_prefill_step(cfg)
    if kind == "decode":
        return make_serve_step(cfg)
    raise ValueError(kind)
