"""deepseek-v2-lite-16b [moe] (arXiv:2405.04434): MLA kv_lora=512,
27L d_model=2048 16H d_ff=1408(per expert) vocab=102400, 64 routed experts
top-6 + 2 shared, first layer dense (d_ff 10944).
NOTE: the assignment prose says "160 routed" (that is V2-full's count);
V2-Lite has 64 routed experts — we follow the structured field (64e)."""
from repro_torch.models.config import MLAConfig, ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-lite-16b",
        family="moe",
        num_layers=27,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        d_ff=1408,
        vocab_size=102400,
        mla=MLAConfig(kv_lora_rank=512, q_lora_rank=0,
                      qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
        moe=MoEConfig(num_experts=64, top_k=6, d_expert=1408,
                      num_shared=2, first_k_dense=1, dense_d_ff=10944),
        notes=(
            "vocab 102400 = 50*2048; no padding",
            "MLA decode cache: compressed (c_kv 512 + k_pe 64) per token",
            "assignment prose said 160 routed (V2-full); V2-Lite=64 used",
        ),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-smoke",
        family="moe",
        num_layers=3,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        d_ff=32,
        vocab_size=512,
        mla=MLAConfig(kv_lora_rank=32, q_lora_rank=0,
                      qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16),
        moe=MoEConfig(num_experts=4, top_k=2, d_expert=32,
                      num_shared=1, first_k_dense=1, dense_d_ff=96),
    )
