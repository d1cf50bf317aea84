"""Model assembly, train/prefill path (port of ``repro/models/transformer.py``).

Family map (as the reference's ``_FORWARD``):
  dense -> forward_dense  (gemma-2b: flat plan of attention + MLP blocks)
  ssm   -> forward_ssm    (mamba2-370m: Mamba-2 SSD blocks, no cache)

Each family is token embedding, a stack of identical blocks whose weights
are stacked along a leading layer axis, and a tied or separate LM head. The
reference scans the stack with ``lax.scan``; here a Python loop indexes the
stacked weights. MoE, MLA, the gemma3 local/global plan, the hybrid, encdec
and vlm families and the decode caches come with later slices (ROADMAP.md).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from ..tree import tree_flatten, tree_map, tree_unflatten
from .config import ModelConfig
from .layers import attention, attn_descs, mlp, mlp_descs, rms_norm
from .params import PDesc, stack_tree
from .ssm import mamba2_mixer, ssm_descs


def _block_descs(cfg: ModelConfig, *, kind: str) -> Dict:
    """kind: attn | ssm"""
    d = cfg.d_model
    descs: Dict = {"ln1": PDesc((d,), ("embed",), init="zeros")}
    if kind == "ssm":
        descs["mixer"] = ssm_descs(cfg)
        return descs  # mamba block has its own epilogue norm
    descs["attn"] = attn_descs(cfg)
    descs["ln2"] = PDesc((d,), ("embed",), init="zeros")
    descs["mlp"] = mlp_descs(cfg)
    return descs


def _embed_descs(cfg: ModelConfig) -> Dict:
    descs = {
        "embed": PDesc((cfg.vocab_padded, cfg.d_model), ("vocab", "embed")),
        "ln_f": PDesc((cfg.d_model,), ("embed",), init="zeros"),
    }
    if not cfg.tie_embeddings:
        descs["lm_head"] = PDesc((cfg.d_model, cfg.vocab_padded), ("embed", "vocab"))
    return descs


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.family == "ssm" and cfg.ssm is not None:
        return
    if cfg.family != "dense" or cfg.global_period or cfg.moe or cfg.mla:
        raise NotImplementedError(
            f"{cfg.name}: only the flat dense plan and the ssm family are ported yet")


def dense_descs(cfg: ModelConfig) -> Dict:
    descs = _embed_descs(cfg)
    descs["layers"] = stack_tree(_block_descs(cfg, kind="attn"), cfg.num_layers)
    return descs


def ssm_descs_tree(cfg: ModelConfig) -> Dict:
    descs = _embed_descs(cfg)
    descs["layers"] = stack_tree(_block_descs(cfg, kind="ssm"), cfg.num_layers)
    return descs


_DESCS = {"dense": dense_descs, "ssm": ssm_descs_tree}


def param_descs(cfg: ModelConfig) -> Dict:
    _check_supported(cfg)
    return _DESCS[cfg.family](cfg)


def _embed(cfg: ModelConfig, params: Dict, tokens: torch.Tensor) -> torch.Tensor:
    x = params["embed"][tokens]
    if cfg.activation == "gelu":  # gemma family scales embeddings
        x = x * torch.tensor(np.sqrt(cfg.d_model), dtype=x.dtype, device=x.device)
    return x


def apply_head(cfg: ModelConfig, params: Dict, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    if cfg.tie_embeddings:
        return torch.einsum("bsd,vd->bsv", x, params["embed"])
    return torch.einsum("bsd,dv->bsv", x, params["lm_head"])


def _block_apply(cfg: ModelConfig, lp: Dict, x: torch.Tensor,
                 positions: torch.Tensor, *, kind: str) -> torch.Tensor:
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    if kind == "ssm":
        out, _ = mamba2_mixer(lp["mixer"], h, cfg)
        return x + out
    x = x + attention(lp["attn"], h, cfg, positions)
    h2 = rms_norm(x, lp["ln2"], cfg.norm_eps)
    return x + mlp(lp["mlp"], h2, cfg.activation)


def _stack(cfg: ModelConfig, params: Dict, tokens: torch.Tensor, kind: str) -> torch.Tensor:
    B, S = tokens.shape
    positions = torch.arange(S, dtype=torch.int32, device=tokens.device)[None].expand(B, S)
    x = _embed(cfg, params, tokens)
    for i in range(cfg.num_layers):
        lp = tree_map(lambda w: w[i], params["layers"])
        x = _block_apply(cfg, lp, x, positions, kind=kind)
    return apply_head(cfg, params, x)


def forward_dense(cfg: ModelConfig, params: Dict, tokens: torch.Tensor) -> torch.Tensor:
    """tokens (B, S) int -> logits (B, S, vocab_padded)."""
    _check_supported(cfg)
    if cfg.family != "dense":
        raise ValueError(f"{cfg.name} is of the {cfg.family} family, not dense")
    return _stack(cfg, params, tokens, "attn")


def forward_ssm(cfg: ModelConfig, params: Dict, tokens: torch.Tensor) -> torch.Tensor:
    """tokens (B, S) int -> logits (B, S, vocab_padded), every mixer on the
    model's own chunked SSD (the reference's forward passes no ssd_impl)."""
    _check_supported(cfg)
    if cfg.family != "ssm":
        raise ValueError(f"{cfg.name} is of the {cfg.family} family, not ssm")
    return _stack(cfg, params, tokens, "ssm")


_FORWARD = {"dense": forward_dense, "ssm": forward_ssm}


def forward(cfg: ModelConfig, params: Dict, tokens: torch.Tensor) -> torch.Tensor:
    """Dispatch by family, as the reference's ``forward``; returns logits
    only (the reference also returns its decode cache and MoE aux loss,
    which these families do not produce without a cache)."""
    _check_supported(cfg)
    return _FORWARD[cfg.family](cfg, params, tokens)


def lm_loss(cfg: ModelConfig, logits: torch.Tensor, labels: torch.Tensor,
            aux: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token cross-entropy; padded vocab entries are masked out."""
    logits = logits.float()
    if cfg.vocab_padded != cfg.vocab_size:
        pad = torch.arange(cfg.vocab_padded, device=logits.device) >= cfg.vocab_size
        logits = torch.where(pad[None, None, :], torch.full_like(logits, -1e30), logits)
    logz = torch.logsumexp(logits, dim=-1)
    B, S = labels.shape
    b_idx = torch.arange(B, device=labels.device)[:, None]
    s_idx = torch.arange(S, device=labels.device)[None, :]
    # advanced indexing (backward: deterministic index_put) rather than gather
    ll = logits[b_idx, s_idx, labels.long()]
    loss = torch.mean(logz - ll)
    return loss if aux is None else loss + aux


def _leaf_names(tree: Dict, prefix: str = ""):
    """Tree paths joined by "__", in flatten (sorted-key) order."""
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaf_names(tree[k], f"{prefix}{k}__")
        else:
            yield f"{prefix}{k}"


class DenseLM(nn.Module):
    """The dense model as an ``nn.Module``: its parameters are the leaves of
    the reference's parameter tree, registered under their tree paths, and
    ``forward`` maps tokens to logits. ``tree()`` gives the nested dict that
    the functional training path, the optimizer and the checkpoint codec use."""

    def __init__(self, cfg: ModelConfig, params: Dict) -> None:
        super().__init__()
        self.cfg = cfg
        leaves, self._treedef = tree_flatten(params)
        self._names = list(_leaf_names(params))
        for name, leaf in zip(self._names, leaves):
            self.register_parameter(name, nn.Parameter(leaf))

    def tree(self) -> Dict:
        return tree_unflatten(self._treedef, [getattr(self, n) for n in self._names])

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return forward_dense(self.cfg, self.tree(), tokens)
