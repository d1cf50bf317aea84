"""Model assembly, prefill and decode (port of ``repro/models/transformer.py``).

Family map (as the reference's ``_FORWARD``):
  dense / moe -> forward_dense  (the flat plan: gemma-2b, yi-6b, glm4-9b,
                                 granite-moe-3b-a800m; the grouped
                                 local/global plan: gemma3-4b; the deepseek
                                 plan of MLA blocks: deepseek-v2-lite-16b)
  ssm         -> forward_ssm    (mamba2-370m: Mamba-2 SSD blocks)
  hybrid      -> forward_hybrid (zamba2-1.2b: one shared attention block
                                 before each group of SSM blocks)
  encdec      -> forward_encdec (seamless-m4t-large-v2: a non-causal encoder
                                 over the stub audio frames, a decoder of
                                 self-attention, cross-attention to the
                                 encoder output and an MLP)
  vlm         -> forward_vlm    (llama-3.2-vision-90b: groups of self blocks,
                                 each group closed by a tanh-gated
                                 cross-attention block over the stub image
                                 embeddings)

Each family is token embedding, stacks of identical blocks whose weights
are stacked along a leading layer axis, and a tied or separate LM head. The
reference scans each stack with ``lax.scan`` (``models/scan_utils.py``);
here a Python loop indexes the stacked weights, so that module has no
counterpart. gemma3's plan nests two stacks: ``group_locals`` is
(groups, locals, ...), ``group_global`` (groups, ...), and ``tail_locals``
the locals after the last group; its local layers attend within a sliding
window and decode into window-sized ring caches. deepseek's plan stacks
``dense_layers`` (MLA with a dense MLP) and then ``moe_layers`` (MLA with
MoE); zamba2's applies the one ``shared_attn`` weight set at each group,
each site with its own KV cache, so under autograd its gradient sums over
the sites. The vlm plan nests ``group_selfs`` (groups, period - 1, ...)
and stacks ``group_cross`` (groups, ...); its cross blocks keep no cache.
The encdec decode cache holds the decoder's KV caches and ``enc_out``, the
encoder output that ``decode_step`` cross-attends to: a cache from
``cache_descs`` holds zeros there until a ``forward`` with a cache
(``enc_out`` None) runs the encoder and stores its output, as in the
reference. Cross-attention K and V are projected from the source at every
call, decode steps included. ``forward`` takes the encdec ``frames`` and
the vlm ``image_embeds`` from ``extras`` and raises ``KeyError`` without
them. Every family forward returns the reference's triple (logits,
cache, aux): the cache is None without one, and aux is the MoE blocks'
summed load-balance loss, a 0-d f32 zero for a model without MoE. With a
decode cache (``cache_descs``, ``decode_step``) the loop hands each block
per-layer views of the stacked cache buffers, and the blocks write their
new k/v, MLA latent or conv/SSM state through those views in place: the
cache tree passed in is updated and returned, not copied, where the
reference re-stacks a new tree every step.
Training may recompute each block in the backward pass (``remat``), and the
LM loss may run chunk by chunk (``chunked_lm_loss``, ``Tuning.loss_chunk``).
"""
from __future__ import annotations

import functools
import operator
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..tree import tree_flatten, tree_map, tree_unflatten
from .config import ModelConfig
from .layers import (attention, attn_descs, mla_attention, mla_descs, mlp, mlp_descs, moe,
                     moe_descs, rms_norm)
from .params import PDesc, stack_tree
from .ssm import mamba2_mixer, ssm_descs
from .tuning import constrain_batch_sharded, get_tuning

F32 = torch.float32


def _block_descs(cfg: ModelConfig, *, kind: str, dense_ff: Optional[int] = None) -> Dict:
    """kind: attn | mla | attn_moe | mla_moe | ssm | cross"""
    d = cfg.d_model
    descs: Dict = {"ln1": PDesc((d,), ("embed",), init="zeros")}
    if kind == "ssm":
        descs["mixer"] = ssm_descs(cfg)
        return descs  # mamba block has its own epilogue norm
    if kind == "cross":  # vlm: both residual branches tanh-gated, the gates 0 at init
        descs["attn"] = attn_descs(cfg, cross=True)
        descs["ln2"] = PDesc((d,), ("embed",), init="zeros")
        descs["mlp"] = mlp_descs(cfg)
        descs["mlp_gate"] = PDesc((1,), (None,), init="zeros")
        return descs
    descs["attn"] = mla_descs(cfg) if kind.startswith("mla") else attn_descs(cfg)
    descs["ln2"] = PDesc((d,), ("embed",), init="zeros")
    if kind.endswith("moe"):
        descs["moe"] = moe_descs(cfg)
    else:
        descs["mlp"] = mlp_descs(cfg, d_ff=dense_ff)
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
    if cfg.family not in _FORWARD:
        raise ValueError(f"{cfg.name}: unknown model family {cfg.family!r} (have "
                         f"{sorted(_FORWARD)})")


def _dense_plan(cfg: ModelConfig) -> Dict:
    """Segments of homogeneous stacks for the dense, moe and mla archs."""
    if cfg.global_period:  # gemma3: groups of (p-1) local + 1 global, + tail
        p = cfg.global_period
        n_groups = cfg.num_layers // p
        tail = cfg.num_layers - n_groups * p
        return {"kind": "gemma3", "groups": n_groups, "locals": p - 1, "tail": tail}
    if cfg.moe is not None and cfg.moe.first_k_dense:
        return {"kind": "deepseek", "dense": cfg.moe.first_k_dense,
                "moe": cfg.num_layers - cfg.moe.first_k_dense}
    return {"kind": "flat", "layers": cfg.num_layers}


def _attn_kind(cfg: ModelConfig) -> str:
    if cfg.mla is not None:
        return "mla_moe" if cfg.moe is not None else "mla"
    return "attn_moe" if cfg.moe is not None else "attn"


def dense_descs(cfg: ModelConfig) -> Dict:
    plan = _dense_plan(cfg)
    descs = _embed_descs(cfg)
    if plan["kind"] == "flat":
        descs["layers"] = stack_tree(_block_descs(cfg, kind=_attn_kind(cfg)), plan["layers"])
        return descs
    if plan["kind"] == "deepseek":
        dense_block = _block_descs(cfg, kind="mla", dense_ff=cfg.moe.dense_d_ff)
        descs["dense_layers"] = stack_tree(dense_block, plan["dense"])
        descs["moe_layers"] = stack_tree(_block_descs(cfg, kind="mla_moe"), plan["moe"])
        return descs
    local = _block_descs(cfg, kind="attn")
    descs["group_locals"] = stack_tree(stack_tree(local, plan["locals"]), plan["groups"])
    descs["group_global"] = stack_tree(_block_descs(cfg, kind="attn"), plan["groups"])
    if plan["tail"]:
        descs["tail_locals"] = stack_tree(local, plan["tail"])
    return descs


def ssm_descs_tree(cfg: ModelConfig) -> Dict:
    descs = _embed_descs(cfg)
    descs["layers"] = stack_tree(_block_descs(cfg, kind="ssm"), cfg.num_layers)
    return descs


def _hybrid_plan(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(period, groups, tail SSM layers) of the zamba2 plan."""
    p = cfg.hybrid_attn_period
    n_groups = cfg.num_layers // p
    return p, n_groups, cfg.num_layers - n_groups * p


def hybrid_descs(cfg: ModelConfig) -> Dict:
    p, n_groups, tail = _hybrid_plan(cfg)
    descs = _embed_descs(cfg)
    descs["shared_attn"] = _block_descs(cfg, kind="attn")  # ONE shared block
    descs["group_ssm"] = stack_tree(stack_tree(_block_descs(cfg, kind="ssm"), p), n_groups)
    if tail:
        descs["tail_ssm"] = stack_tree(_block_descs(cfg, kind="ssm"), tail)
    return descs


def encdec_descs(cfg: ModelConfig) -> Dict:
    descs = _embed_descs(cfg)
    descs["encoder"] = stack_tree(_block_descs(cfg, kind="attn"), cfg.encoder_layers)
    dec_block = _block_descs(cfg, kind="attn")
    dec_block["ln_cross"] = PDesc((cfg.d_model,), ("embed",), init="zeros")
    dec_block["cross_attn"] = attn_descs(cfg)  # no gate
    descs["decoder"] = stack_tree(dec_block, cfg.num_layers)
    return descs


def _vlm_plan(cfg: ModelConfig) -> Tuple[int, int]:
    """(period, groups) of the vlm plan: each group is period - 1 self
    blocks and one cross block."""
    p = cfg.cross_attn_period
    return p, cfg.num_layers // p


def vlm_descs(cfg: ModelConfig) -> Dict:
    p, n_groups = _vlm_plan(cfg)
    descs = _embed_descs(cfg)
    descs["group_selfs"] = stack_tree(stack_tree(_block_descs(cfg, kind="attn"), p - 1), n_groups)
    descs["group_cross"] = stack_tree(_block_descs(cfg, kind="cross"), n_groups)
    return descs


_DESCS = {"dense": dense_descs, "moe": dense_descs, "ssm": ssm_descs_tree,
          "hybrid": hybrid_descs, "encdec": encdec_descs, "vlm": vlm_descs}


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


def _logits(cfg: ModelConfig, params: Dict, x: torch.Tensor, last_only: bool = False):
    if last_only:
        x = x[:, -1:]
    elif get_tuning().loss_chunk:
        # leave hidden states: chunked_lm_loss applies the head chunk-wise to
        # bound the f32 logits working set
        return x
    return apply_head(cfg, params, x)


Aux = Optional[torch.Tensor]


def _add(a: Aux, b: Aux) -> Aux:
    """Sum of two aux losses, where None is a block without MoE (no zero
    tensor is made, and no launch, for each such block)."""
    return b if a is None else a if b is None else a + b


def _block_apply(cfg: ModelConfig, lp: Dict, x: torch.Tensor, positions: torch.Tensor,
                 *, kind: str, window: Optional[int] = None, cache: Optional[Dict] = None,
                 cache_index: Optional[int] = None, ring: bool = False,
                 cross_src: Optional[torch.Tensor] = None,
                 causal: bool = True) -> Tuple[torch.Tensor, Aux]:
    """One block -> (x, its MoE aux loss or None); with a cache, its
    per-layer views are updated in place. A "cross" block attends to
    ``cross_src`` and keeps no cache."""
    x = constrain_batch_sharded(x)  # a no-op unless tuned, and on plain tensors
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    if kind == "ssm":
        out, new = mamba2_mixer(lp["mixer"], h, cfg, cache=cache)
        if cache is not None:
            cache["conv"].copy_(new["conv"])
            cache["state"].copy_(new["state"])
        return x + out, None
    if kind == "cross":
        out, _ = attention(lp["attn"], h, cfg, positions, cross_src=cross_src, causal=False)
        x = x + out * torch.tanh(lp["attn"]["gate"].to(x.dtype))
        h2 = rms_norm(x, lp["ln2"], cfg.norm_eps)
        m = mlp(lp["mlp"], h2, cfg.activation)
        return x + m * torch.tanh(lp["mlp_gate"].to(x.dtype)), None
    if kind.startswith("mla"):
        out, _ = mla_attention(lp["attn"], h, cfg, positions, cache=cache,
                               cache_index=cache_index)
    else:
        out, _ = attention(lp["attn"], h, cfg, positions, window=window, cache=cache,
                           cache_index=cache_index, ring=ring, causal=causal)
    x = x + out
    h2 = rms_norm(x, lp["ln2"], cfg.norm_eps)
    if kind.endswith("moe"):
        m, aux = moe(lp["moe"], h2, cfg)
        return x + m, aux
    return x + mlp(lp["mlp"], h2, cfg.activation), None


def _keep_weight_products(ctx, func, *args, **kwargs):
    """The "dots" policy: keep the output of every product with no batch
    dimension and recompute the rest. ``torch.einsum`` runs a product as a
    ``bmm`` whose leading dim is the product of the batch dims, so these are
    the ``bmm`` of batch 1: the weight products x.W (q/k/v/o, the MLP, the
    mixer's projections). Attention's per-(batch, head) products, the SSD
    einsums, norms and activations are recomputed; a per-head product whose
    batch x heads is 1 is kept too."""
    if func is torch.ops.aten.bmm.default and args[0].shape[0] == 1:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _maybe_remat(fn: Callable, policy: str) -> Callable:
    """Recompute ``fn`` in the backward pass instead of keeping its
    activations: "none" keeps them all, "full" keeps only ``fn``'s inputs
    (``jax.checkpoint``), "dots" also keeps the weight products
    (``checkpoint_dots_with_no_batch_dims``; ``_keep_weight_products``).
    Without autograd recording (prefill, decode) ``fn`` runs as it is."""
    if policy == "none":
        return fn
    if policy not in ("dots", "full"):
        raise ValueError(f"remat policy {policy!r}: expected none, dots or full")
    kw = {}
    if policy == "dots":
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts,
                                             _keep_weight_products)

    @functools.wraps(fn)
    def remat(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return checkpoint(fn, *args, use_reentrant=False, **kw)

    return remat


def _layer(tree: Optional[Dict], *idx: int) -> Optional[Dict]:
    """The per-layer slice ``t[i][j]...`` of every leaf of a stacked tree
    (weights, or views of the decode cache that write through)."""
    if tree is None:
        return None

    def pick(t):
        for i in idx:
            t = t[i]
        return t

    return tree_map(pick, tree)


def _run_stack(cfg: ModelConfig, stacked: Dict, x: torch.Tensor, positions: torch.Tensor, *,
               kind: str, window: Optional[int] = None, cache: Optional[Dict] = None,
               cache_index: Optional[int] = None, ring: bool = False, causal: bool = True,
               remat: str = "none") -> Tuple[torch.Tensor, Aux]:
    """The reference's ``_scan_stack``: every layer of a stacked block ->
    (x, the layers' summed aux loss or None)."""
    n = tree_flatten(stacked)[0][0].shape[0]

    def body(lp, h, c):
        return _block_apply(cfg, lp, h, positions, kind=kind, window=window, cache=c,
                            cache_index=cache_index, ring=ring, causal=causal)

    body = _maybe_remat(body, remat)
    aux = None
    for i in range(n):
        x, a = body(_layer(stacked, i), x, _layer(cache, i))
        aux = _add(aux, a)
    return x, aux


def _positions(tokens: torch.Tensor, cache: Optional[Dict], cache_index: Optional[int]):
    B, S = tokens.shape
    if cache is None:
        return torch.arange(S, dtype=torch.int32, device=tokens.device)[None].expand(B, S)
    return torch.full((B, S), operator.index(cache_index), dtype=torch.int32,
                      device=tokens.device)


def _check_family(cfg: ModelConfig, *families: str) -> None:
    _check_supported(cfg)
    if cfg.family not in families:
        raise ValueError(f"{cfg.name} is of the {cfg.family} family, not {' or '.join(families)}")


def _result(cfg: ModelConfig, params: Dict, x: torch.Tensor, last_only: bool,
            cache: Optional[Dict], aux: Aux) -> Tuple[torch.Tensor, Optional[Dict], torch.Tensor]:
    if aux is None:
        aux = torch.zeros((), dtype=F32, device=x.device)
    return _logits(cfg, params, x, last_only), cache, aux


def forward_dense(cfg: ModelConfig, params: Dict, tokens: torch.Tensor,
                  last_only: bool = False, *, remat: str = "none",
                  cache: Optional[Dict] = None, cache_index: Optional[int] = None):
    """tokens (B, S) int -> (logits (B, S, vocab_padded), cache, aux): the
    last position alone under ``last_only``, hidden states under
    ``Tuning.loss_chunk``; without a cache the cache is None, with one it
    is single-token decode at ``cache_index`` and the cache comes back
    updated in place. aux is the MoE blocks' load-balance loss (0-d)."""
    _check_family(cfg, "dense", "moe")
    plan = _dense_plan(cfg)
    decode = cache is not None
    positions = _positions(tokens, cache, cache_index)
    x = _embed(cfg, params, tokens)
    if plan["kind"] == "flat":
        x, aux = _run_stack(cfg, params["layers"], x, positions, kind=_attn_kind(cfg),
                            cache=cache["layers"] if decode else None,
                            cache_index=cache_index, remat=remat)
    elif plan["kind"] == "deepseek":
        x, a1 = _run_stack(cfg, params["dense_layers"], x, positions, kind="mla",
                           cache=cache["dense_layers"] if decode else None,
                           cache_index=cache_index, remat=remat)
        x, a2 = _run_stack(cfg, params["moe_layers"], x, positions, kind="mla_moe",
                           cache=cache["moe_layers"] if decode else None,
                           cache_index=cache_index, remat=remat)
        aux = _add(a1, a2)
    else:  # gemma3 grouped local/global
        def group_body(gl, gg, cl, cg, h):
            h, a1 = _run_stack(cfg, gl, h, positions, kind="attn", window=cfg.sliding_window,
                               cache=cl, cache_index=cache_index, ring=decode)
            h, a2 = _block_apply(cfg, gg, h, positions, kind="attn", cache=cg,
                                 cache_index=cache_index)
            return h, _add(a1, a2)

        group_body = _maybe_remat(group_body, remat)
        aux = None
        for g in range(plan["groups"]):
            x, a = group_body(_layer(params["group_locals"], g),
                              _layer(params["group_global"], g),
                              _layer(cache["group_locals"], g) if decode else None,
                              _layer(cache["group_global"], g) if decode else None, x)
            aux = _add(aux, a)
        if plan["tail"]:
            x, a = _run_stack(cfg, params["tail_locals"], x, positions, kind="attn",
                              window=cfg.sliding_window,
                              cache=cache["tail_locals"] if decode else None,
                              cache_index=cache_index, ring=decode, remat=remat)
            aux = _add(aux, a)
    return _result(cfg, params, x, last_only, cache, aux)


def forward_ssm(cfg: ModelConfig, params: Dict, tokens: torch.Tensor,
                last_only: bool = False, *, remat: str = "none",
                cache: Optional[Dict] = None, cache_index: Optional[int] = None):
    """tokens (B, S) int -> (logits, cache, aux) as ``forward_dense``, every
    mixer on the model's own chunked SSD (the reference's forward passes no
    ssd_impl); aux is a 0-d zero."""
    _check_family(cfg, "ssm")
    decode = cache is not None
    x = _embed(cfg, params, tokens)
    x, aux = _run_stack(cfg, params["layers"], x, _positions(tokens, cache, cache_index),
                        kind="ssm", cache=cache["layers"] if decode else None,
                        cache_index=cache_index, remat=remat)
    return _result(cfg, params, x, last_only, cache, aux)


def forward_hybrid(cfg: ModelConfig, params: Dict, tokens: torch.Tensor,
                   last_only: bool = False, *, remat: str = "none",
                   cache: Optional[Dict] = None, cache_index: Optional[int] = None):
    """zamba2: the shared attention block, then a group of SSM blocks, for
    each group; then the tail SSM blocks. -> (logits, cache, aux) as
    ``forward_dense``; the shared block's cache has one entry per site."""
    _check_family(cfg, "hybrid")
    _, n_groups, tail = _hybrid_plan(cfg)
    decode = cache is not None
    positions = _positions(tokens, cache, cache_index)
    x = _embed(cfg, params, tokens)

    def group_body(shared, gssm, c_attn, c_ssm, h):
        # the shared attention block (one weight set; a KV cache per site)
        h, a1 = _block_apply(cfg, shared, h, positions, kind="attn", cache=c_attn,
                             cache_index=cache_index)
        h, a2 = _run_stack(cfg, gssm, h, positions, kind="ssm", cache=c_ssm,
                           cache_index=cache_index)
        return h, _add(a1, a2)

    group_body = _maybe_remat(group_body, remat)
    aux = None
    for g in range(n_groups):
        x, a = group_body(params["shared_attn"], _layer(params["group_ssm"], g),
                          _layer(cache["shared_attn"], g) if decode else None,
                          _layer(cache["group_ssm"], g) if decode else None, x)
        aux = _add(aux, a)
    if tail:
        x, a = _run_stack(cfg, params["tail_ssm"], x, positions, kind="ssm",
                          cache=cache["tail_ssm"] if decode else None,
                          cache_index=cache_index, remat=remat)
        aux = _add(aux, a)
    return _result(cfg, params, x, last_only, cache, aux)


def _decoder_block(cfg: ModelConfig, lp: Dict, x: torch.Tensor, positions: torch.Tensor,
                   enc_out: torch.Tensor, cache: Optional[Dict],
                   cache_index: Optional[int]) -> torch.Tensor:
    """The encdec decoder block: causal self-attention (cached in decode),
    cross-attention to ``enc_out`` (no gate), then the MLP."""
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    out, _ = attention(lp["attn"], h, cfg, positions, cache=cache, cache_index=cache_index)
    x = x + out
    hc = rms_norm(x, lp["ln_cross"], cfg.norm_eps)
    out, _ = attention(lp["cross_attn"], hc, cfg, positions, cross_src=enc_out, causal=False)
    x = x + out
    h2 = rms_norm(x, lp["ln2"], cfg.norm_eps)
    return x + mlp(lp["mlp"], h2, cfg.activation)


def forward_encdec(cfg: ModelConfig, params: Dict, tokens: torch.Tensor,
                   last_only: bool = False, *, frames: Optional[torch.Tensor],
                   remat: str = "none", cache: Optional[Dict] = None,
                   cache_index: Optional[int] = None, enc_out: Optional[torch.Tensor] = None):
    """seamless: decoder tokens (B, S) and the stub audio frontend's
    ``frames`` (B, Ssrc, D) -> (logits, cache, aux) as ``forward_dense``.
    The encoder (non-causal, positions 0..Ssrc-1) runs unless ``enc_out``
    gives its output; with a cache, the output used is stored as the
    cache's ``enc_out``. aux is a 0-d zero."""
    _check_family(cfg, "encdec")
    decode = cache is not None
    if enc_out is None:
        B, S_src = frames.shape[:2]
        src_pos = torch.arange(S_src, dtype=torch.int32, device=frames.device)[None].expand(
            B, S_src)
        enc_out, _ = _run_stack(cfg, params["encoder"], frames, src_pos, kind="attn",
                                causal=False, remat=remat)
    positions = _positions(tokens, cache, cache_index)
    x = _embed(cfg, params, tokens)

    def dec_body(lp, h, c, src):
        return _decoder_block(cfg, lp, h, positions, src, c, cache_index)

    dec_body = _maybe_remat(dec_body, remat)
    for i in range(cfg.num_layers):
        x = dec_body(_layer(params["decoder"], i), x,
                     _layer(cache["decoder"], i) if decode else None, enc_out)
    if decode:
        cache["enc_out"] = enc_out
    return _result(cfg, params, x, last_only, cache, None)


def forward_vlm(cfg: ModelConfig, params: Dict, tokens: torch.Tensor,
                last_only: bool = False, *, image_embeds: torch.Tensor,
                remat: str = "none", cache: Optional[Dict] = None,
                cache_index: Optional[int] = None):
    """llama-3.2-vision: tokens (B, S) and the stub vision frontend's
    ``image_embeds`` (B, Nimg, D) -> (logits, cache, aux) as
    ``forward_dense``. Each group runs its self blocks (cached in decode),
    then its gated cross block over ``image_embeds``. aux is a 0-d zero."""
    _check_family(cfg, "vlm")
    _, n_groups = _vlm_plan(cfg)
    decode = cache is not None
    positions = _positions(tokens, cache, cache_index)
    x = _embed(cfg, params, tokens)

    def group_body(gs, gc, cs, h, img):
        h, _ = _run_stack(cfg, gs, h, positions, kind="attn", cache=cs, cache_index=cache_index)
        return _block_apply(cfg, gc, h, positions, kind="cross", cross_src=img)[0]

    group_body = _maybe_remat(group_body, remat)
    for g in range(n_groups):
        x = group_body(_layer(params["group_selfs"], g), _layer(params["group_cross"], g),
                       _layer(cache["group_selfs"], g) if decode else None, x, image_embeds)
    return _result(cfg, params, x, last_only, cache, None)


_FORWARD = {"dense": forward_dense, "moe": forward_dense, "ssm": forward_ssm,
            "hybrid": forward_hybrid, "encdec": forward_encdec, "vlm": forward_vlm}


def forward(cfg: ModelConfig, params: Dict, tokens: torch.Tensor, *, extras=None, **kw):
    """Dispatch by family, as the reference's ``forward``; ``kw`` are the
    family forward's (``last_only``, ``remat``, ``cache``, ``cache_index``).
    Returns the reference's (logits, cache, aux). ``extras`` feed the encdec
    family its ``"frames"`` and the vlm family its ``"image_embeds"`` (a
    ``KeyError`` without them); the others ignore them, as in the reference."""
    _check_supported(cfg)
    extras = extras or {}
    fwd = _FORWARD[cfg.family]
    if cfg.family == "encdec":
        return fwd(cfg, params, tokens, frames=extras["frames"], **kw)
    if cfg.family == "vlm":
        return fwd(cfg, params, tokens, image_embeds=extras["image_embeds"], **kw)
    return fwd(cfg, params, tokens, **kw)


def _attn_cache_desc(cfg: ModelConfig, batch: int, length: int) -> Dict[str, PDesc]:
    nkv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    return {
        "k": PDesc((batch, length, nkv, hd), ("batch", "seq", "kv_heads", None), init="zeros"),
        "v": PDesc((batch, length, nkv, hd), ("batch", "seq", "kv_heads", None), init="zeros"),
    }


def _mla_cache_desc(cfg: ModelConfig, batch: int, length: int) -> Dict[str, PDesc]:
    m = cfg.mla
    return {
        "ckv": PDesc((batch, length, m.kv_lora_rank), ("batch", "seq", None), init="zeros"),
        "kpe": PDesc((batch, length, m.qk_rope_head_dim), ("batch", "seq", None), init="zeros"),
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
    """Decode-cache descriptor tree matching the family's layer stacks."""
    _check_supported(cfg)
    if cfg.family == "ssm":
        return {"layers": stack_tree(_ssm_cache_desc(cfg, batch), cfg.num_layers)}
    if cfg.family == "hybrid":
        p, n_groups, tail = _hybrid_plan(cfg)
        out = {
            "shared_attn": stack_tree(_attn_cache_desc(cfg, batch, max_len), n_groups),
            "group_ssm": stack_tree(stack_tree(_ssm_cache_desc(cfg, batch), p), n_groups),
        }
        if tail:
            out["tail_ssm"] = stack_tree(_ssm_cache_desc(cfg, batch), tail)
        return out
    if cfg.family == "encdec":
        return {
            "decoder": stack_tree(_attn_cache_desc(cfg, batch, max_len), cfg.num_layers),
            "enc_out": PDesc((batch, cfg.source_len, cfg.d_model), ("batch", None, "embed"),
                             init="zeros"),
        }
    if cfg.family == "vlm":
        p, n_groups = _vlm_plan(cfg)
        return {"group_selfs": stack_tree(
            stack_tree(_attn_cache_desc(cfg, batch, max_len), p - 1), n_groups)}
    plan = _dense_plan(cfg)
    mk = _mla_cache_desc if cfg.mla is not None else _attn_cache_desc
    if plan["kind"] == "flat":
        return {"layers": stack_tree(mk(cfg, batch, max_len), plan["layers"])}
    if plan["kind"] == "deepseek":
        return {"dense_layers": stack_tree(mk(cfg, batch, max_len), plan["dense"]),
                "moe_layers": stack_tree(mk(cfg, batch, max_len), plan["moe"])}
    # gemma3: ring caches (window-sized) for locals, full for globals
    w = min(cfg.sliding_window, max_len)
    out = {
        "group_locals": stack_tree(
            stack_tree(_attn_cache_desc(cfg, batch, w), plan["locals"]), plan["groups"]),
        "group_global": stack_tree(_attn_cache_desc(cfg, batch, max_len), plan["groups"]),
    }
    if plan["tail"]:
        out["tail_locals"] = stack_tree(_attn_cache_desc(cfg, batch, w), plan["tail"])
    return out


def decode_step(cfg: ModelConfig, params: Dict, cache: Dict, tokens: torch.Tensor,
                cache_index: int, *, extras=None) -> Tuple[torch.Tensor, Dict]:
    """tokens (B, 1) at position ``cache_index`` (a host int) -> (logits
    (B, 1, vocab_padded), the cache updated in place). encdec decodes
    against the cache's ``enc_out`` (zeros until a ``forward`` with the
    cache stored the encoder's output, as in the reference); the vlm takes
    ``extras["image_embeds"]``."""
    if cfg.family == "encdec":
        logits, cache, _ = forward_encdec(cfg, params, tokens,
                                          frames=(extras or {}).get("frames"), cache=cache,
                                          cache_index=cache_index, enc_out=cache.get("enc_out"))
        return logits, cache
    logits, cache, _ = forward(cfg, params, tokens, extras=extras, cache=cache,
                               cache_index=cache_index)
    return logits, cache


def _token_nll(cfg: ModelConfig, logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """-log p(label) per position, in f32; padded vocab entries masked out."""
    logits = logits.float()
    if cfg.vocab_padded != cfg.vocab_size:
        pad = torch.arange(cfg.vocab_padded, device=logits.device) >= cfg.vocab_size
        logits = torch.where(pad[None, None, :], torch.full_like(logits, -1e30), logits)
    logz = torch.logsumexp(logits, dim=-1)
    B, S = labels.shape
    b_idx = torch.arange(B, device=labels.device)[:, None]
    s_idx = torch.arange(S, device=labels.device)[None, :]
    # advanced indexing (backward: deterministic index_put) rather than gather
    return logz - logits[b_idx, s_idx, labels.long()]


def lm_loss(cfg: ModelConfig, logits: torch.Tensor, labels: torch.Tensor,
            aux: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token cross-entropy; padded vocab entries are masked out."""
    loss = torch.mean(_token_nll(cfg, logits, labels))
    return loss if aux is None else loss + aux


def chunked_lm_loss(cfg: ModelConfig, params: Dict, hidden: torch.Tensor, labels: torch.Tensor,
                    aux: Optional[torch.Tensor], chunk: int) -> torch.Tensor:
    """LM head + cross-entropy over sequence chunks of ``hidden`` (B, S, D),
    the forward's output under ``Tuning.loss_chunk``; each chunk is
    recomputed in the backward pass, so a (B, chunk, V) f32 block of logits
    is the only head-sized live tensor. Falls back to the full loss when
    ``chunk`` does not divide S, as the reference does."""
    B, S, _ = hidden.shape
    if S % chunk != 0:
        return lm_loss(cfg, apply_head(cfg, params, hidden), labels, aux)

    def body(xc, yc):
        return torch.sum(_token_nll(cfg, apply_head(cfg, params, xc), yc))

    body = _maybe_remat(body, "full")
    total = torch.zeros((), dtype=F32, device=hidden.device)
    for c in range(0, S, chunk):
        total = total + body(hidden[:, c: c + chunk], labels[:, c: c + chunk])
    loss = total / (B * S)
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
        return forward_dense(self.cfg, self.tree(), tokens)[0]
