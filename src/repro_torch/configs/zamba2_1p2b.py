"""zamba2-1.2b [hybrid] (arXiv:2411.15242; hf): Mamba2 backbone + SHARED
attention block. 38L d_model=2048 32H (kv=32) d_ff=8192 vocab=32000,
ssm_state=64. One shared attn(+MLP) block (single weight set) is applied
every 6 SSM layers (6 groups + 2 tail SSM layers)."""
from repro_torch.models.config import ModelConfig, SSMConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-1.2b",
        family="hybrid",
        num_layers=38,
        d_model=2048,
        num_heads=32,
        num_kv_heads=32,
        d_ff=8192,
        vocab_size=32000,
        ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64, n_groups=1),
        hybrid_attn_period=6,
        notes=(
            "vocab 32000 padded to 32768 (16*2048)",
            "shared attention block: one weight set, 6 application sites "
            "(each site has its own KV cache)",
        ),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-smoke",
        family="hybrid",
        num_layers=5,  # 2 groups of 2 + 1 tail
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        d_ff=128,
        vocab_size=512,
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16, n_groups=1, chunk_size=8),
        hybrid_attn_period=2,
    )
