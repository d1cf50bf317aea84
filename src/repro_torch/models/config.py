"""Model configuration covering all 10 assigned architecture families.

One dataclass family; unused sub-configs are None. Exact dimensions live in
``repro.configs.<arch>`` (one file per assigned architecture).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import List, Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_expert: int                    # per-expert FFN hidden size
    num_shared: int = 0              # always-on shared experts (DeepSeek)
    first_k_dense: int = 0           # leading dense (non-MoE) layers
    dense_d_ff: int = 0              # FFN size of those dense layers
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01  # load-balance loss weight


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 Multi-head Latent Attention."""
    kv_lora_rank: int = 512
    q_lora_rank: int = 0             # 0 => full-rank Q projection (V2-Lite)
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 (SSD) mixer."""
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk_size: int = 256

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 => d_model // num_heads
    # attention details
    rope_theta: float = 10000.0
    sliding_window: Optional[int] = None   # local-attention window size
    global_period: int = 0           # gemma3: every Nth layer is global (rest local)
    activation: str = "silu"         # silu (SwiGLU) | gelu (GeGLU)
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    logit_softcap: float = 0.0
    # family extensions
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid (zamba2): one shared attention block applied every N SSM layers
    hybrid_attn_period: int = 0
    # encoder-decoder (seamless): encoder depth; num_layers = decoder depth
    encoder_layers: int = 0
    source_len: int = 1024           # stubbed modality frontend: frame count
    # vlm (llama-3.2-vision): one gated cross-attn layer every N layers
    cross_attn_period: int = 0
    num_image_tokens: int = 1024
    # notes recorded per-config (vocab padding, interpretation decisions)
    notes: Tuple[str, ...] = ()

    # -- derived -----------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def vocab_padded(self) -> int:
        """Pad vocab to a multiple of 2048 (16 model shards x 128 MXU lanes)."""
        m = 2048
        return ((self.vocab_size + m - 1) // m) * m

    def layer_kinds(self) -> List[str]:
        """Per-layer mixer kind, for heterogeneous stacks."""
        kinds: List[str] = []
        for i in range(self.num_layers):
            if self.family in ("ssm", "hybrid"):
                kinds.append("ssm")
            elif self.global_period and (i + 1) % self.global_period != 0:
                kinds.append("local_attn")
            else:
                kinds.append("attn")
        return kinds

    def supports_long_context(self) -> bool:
        """True iff a 500k-token decode is architecturally sub-quadratic:
        SSM/hybrid (O(1) state) or sliding-window-dominant stacks."""
        return self.family in ("ssm", "hybrid") or self.sliding_window is not None

    def has_decoder(self) -> bool:
        return True  # all assigned archs have a decode path (enc-dec included)

    def param_count(self) -> int:
        """Analytic parameter count (embedding included once)."""
        d, L = self.d_model, self.num_layers
        hd = self.resolved_head_dim
        n_q, n_kv = self.num_heads, self.num_kv_heads
        total = self.vocab_padded * d  # embed
        if not self.tie_embeddings:
            total += self.vocab_padded * d
        total += d  # final norm

        def attn_params() -> int:
            if self.mla is not None:
                m = self.mla
                qk_dim = m.qk_nope_head_dim + m.qk_rope_head_dim
                p = d * (m.q_lora_rank or 0)
                q_in = m.q_lora_rank or d
                p += q_in * n_q * qk_dim
                p += d * (m.kv_lora_rank + m.qk_rope_head_dim)
                p += m.kv_lora_rank * n_q * (m.qk_nope_head_dim + m.v_head_dim)
                p += n_q * m.v_head_dim * d
                return p
            return d * n_q * hd + 2 * d * n_kv * hd + n_q * hd * d

        def mlp_params(ff: int) -> int:
            return 3 * d * ff  # gated MLP

        def ssm_params() -> int:
            s = self.ssm
            di = s.d_inner(d)
            nh = s.n_heads(d)
            p = d * (2 * di + 2 * s.n_groups * s.d_state + nh)  # in_proj
            p += s.d_conv * (di + 2 * s.n_groups * s.d_state)   # conv
            p += nh * 2 + di                                     # A, D, dt_bias-ish
            p += di * d                                          # out_proj
            return p

        for i, kind in enumerate(self.layer_kinds()):
            total += 2 * d  # norms
            if kind == "ssm":
                total += ssm_params()
            else:
                total += attn_params()
                if self.moe is not None:
                    mo = self.moe
                    if i < mo.first_k_dense:
                        total += mlp_params(mo.dense_d_ff)
                    else:
                        total += d * mo.num_experts  # router
                        total += mo.num_experts * 3 * d * mo.d_expert
                        total += mo.num_shared * 3 * d * mo.d_expert
                else:
                    total += mlp_params(self.d_ff)
        if self.family in ("ssm",):
            pass
        if self.hybrid_attn_period:
            total += attn_params() + mlp_params(self.d_ff) + 2 * d  # shared block
        if self.encoder_layers:
            total += self.encoder_layers * (2 * d + attn_params() + mlp_params(self.d_ff))
            total += self.num_layers * (d + attn_params())  # decoder cross-attn
        if self.cross_attn_period:
            n_cross = self.num_layers // self.cross_attn_period
            total += n_cross * (attn_params() + 2 * d + 2)
        return total


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned (input-shape) cell."""
    name: str                        # train_4k | prefill_32k | decode_32k | long_500k
    kind: str                        # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", "train", 4096, 256),
    ShapeConfig("prefill_32k", "prefill", 32768, 32),
    ShapeConfig("decode_32k", "decode", 32768, 128),
    ShapeConfig("long_500k", "decode", 524288, 1),
)


def shape_by_name(name: str) -> ShapeConfig:
    for s in SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)
