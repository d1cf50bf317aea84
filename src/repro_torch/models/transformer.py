"""Model assembly, prefill and decode (port of ``repro/models/transformer.py``).

Family map (as the reference's ``_FORWARD``):
  dense -> forward_dense  (gemma-2b: flat plan of attention + MLP blocks)
  ssm   -> forward_ssm    (mamba2-370m: Mamba-2 SSD blocks)

Each family is token embedding, a stack of identical blocks whose weights
are stacked along a leading layer axis, and a tied or separate LM head. The
reference scans the stack with ``lax.scan``; here a Python loop indexes the
stacked weights. With a decode cache (``cache_descs``, ``decode_step``) the
loop hands each block per-layer views of the stacked cache buffers, and the
blocks write their new k/v or conv/SSM state through those views in place:
the cache tree passed in is updated and returned, not copied, where the
reference re-stacks a new tree every step. MoE, MLA, the gemma3 local/global
plan, the hybrid, encdec and vlm families come with later slices
(ROADMAP.md section 1, item 2).
"""
from __future__ import annotations

import operator
from typing import Dict, Optional, Tuple

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
            f"{cfg.name}: only the flat dense plan and the ssm family are ported yet "
            "(ROADMAP.md section 1, item 2)")


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


def _block_apply(cfg: ModelConfig, lp: Dict, x: torch.Tensor, positions: torch.Tensor,
                 *, kind: str, cache: Optional[Dict] = None,
                 cache_index: Optional[int] = None) -> torch.Tensor:
    """One block; with a cache, its per-layer views are updated in place."""
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    if kind == "ssm":
        out, new = mamba2_mixer(lp["mixer"], h, cfg, cache=cache)
        if cache is not None:
            cache["conv"].copy_(new["conv"])
            cache["state"].copy_(new["state"])
        return x + out
    out, _ = attention(lp["attn"], h, cfg, positions, cache=cache, cache_index=cache_index)
    x = x + out
    h2 = rms_norm(x, lp["ln2"], cfg.norm_eps)
    return x + mlp(lp["mlp"], h2, cfg.activation)


def _stack(cfg: ModelConfig, params: Dict, tokens: torch.Tensor, kind: str,
           cache: Optional[Dict], cache_index: Optional[int]):
    B, S = tokens.shape
    if cache is None:
        positions = torch.arange(S, dtype=torch.int32, device=tokens.device)[None].expand(B, S)
    else:
        cache_index = operator.index(cache_index)
        positions = torch.full((B, S), cache_index, dtype=torch.int32, device=tokens.device)
    x = _embed(cfg, params, tokens)
    for i in range(cfg.num_layers):
        lp = tree_map(lambda w: w[i], params["layers"])
        c = None if cache is None else tree_map(lambda t: t[i], cache["layers"])
        x = _block_apply(cfg, lp, x, positions, kind=kind, cache=c, cache_index=cache_index)
    logits = apply_head(cfg, params, x)
    return logits if cache is None else (logits, cache)


def forward_dense(cfg: ModelConfig, params: Dict, tokens: torch.Tensor, *,
                  cache: Optional[Dict] = None, cache_index: Optional[int] = None):
    """tokens (B, S) int -> logits (B, S, vocab_padded); with a cache,
    single-token decode at ``cache_index`` -> (logits, the updated cache)."""
    _check_supported(cfg)
    if cfg.family != "dense":
        raise ValueError(f"{cfg.name} is of the {cfg.family} family, not dense")
    return _stack(cfg, params, tokens, "attn", cache, cache_index)


def forward_ssm(cfg: ModelConfig, params: Dict, tokens: torch.Tensor, *,
                cache: Optional[Dict] = None, cache_index: Optional[int] = None):
    """tokens (B, S) int -> logits (B, S, vocab_padded), every mixer on the
    model's own chunked SSD (the reference's forward passes no ssd_impl);
    with a cache, single-token decode -> (logits, the updated cache)."""
    _check_supported(cfg)
    if cfg.family != "ssm":
        raise ValueError(f"{cfg.name} is of the {cfg.family} family, not ssm")
    return _stack(cfg, params, tokens, "ssm", cache, cache_index)


_FORWARD = {"dense": forward_dense, "ssm": forward_ssm}


def forward(cfg: ModelConfig, params: Dict, tokens: torch.Tensor, *,
            cache: Optional[Dict] = None, cache_index: Optional[int] = None):
    """Dispatch by family, as the reference's ``forward``. Without a cache it
    returns logits only (the reference also returns its decode cache and MoE
    aux loss, which these families do not produce without a cache); with a
    cache, (logits, the updated cache)."""
    _check_supported(cfg)
    return _FORWARD[cfg.family](cfg, params, tokens, cache=cache, cache_index=cache_index)


def _attn_cache_desc(cfg: ModelConfig, batch: int, length: int) -> Dict[str, PDesc]:
    nkv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    return {
        "k": PDesc((batch, length, nkv, hd), ("batch", "seq", "kv_heads", None), init="zeros"),
        "v": PDesc((batch, length, nkv, hd), ("batch", "seq", "kv_heads", None), init="zeros"),
    }


def _ssm_cache_desc(cfg: ModelConfig, batch: int) -> Dict[str, PDesc]:
    s = cfg.ssm
    di = s.d_inner(cfg.d_model)
    nh = s.n_heads(cfg.d_model)
    conv_ch = di + 2 * s.n_groups * s.d_state
    return {
        "conv": PDesc((batch, s.d_conv - 1, conv_ch), ("batch", None, "ffn"), init="zeros"),
        "state": PDesc((batch, nh, s.head_dim, s.d_state), ("batch", "heads", None, None),
                       init="zeros"),
    }


def cache_descs(cfg: ModelConfig, batch: int, max_len: int) -> Dict:
    """Decode-cache descriptor tree matching the family's layer stack."""
    _check_supported(cfg)
    if cfg.family == "ssm":
        return {"layers": stack_tree(_ssm_cache_desc(cfg, batch), cfg.num_layers)}
    return {"layers": stack_tree(_attn_cache_desc(cfg, batch, max_len), cfg.num_layers)}


def decode_step(cfg: ModelConfig, params: Dict, cache: Dict, tokens: torch.Tensor,
                cache_index: int) -> Tuple[torch.Tensor, Dict]:
    """tokens (B, 1) at position ``cache_index`` (a host int) -> (logits
    (B, 1, vocab_padded), the cache updated in place). The families not
    ported yet (the encdec branch of the reference among them) raise."""
    return forward(cfg, params, tokens, cache=cache, cache_index=cache_index)


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
