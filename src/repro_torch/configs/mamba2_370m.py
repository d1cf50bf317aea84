"""mamba2-370m [ssm] (arXiv:2405.21060; unverified tier): SSD, attn-free.
48L d_model=1024 ssm_state=128 vocab=50280."""
from repro_torch.models.config import ModelConfig, SSMConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-370m",
        family="ssm",
        num_layers=48,
        d_model=1024,
        num_heads=32,       # = d_inner/head_dim (derived; attention-free)
        num_kv_heads=32,
        d_ff=0,
        vocab_size=50280,
        ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, n_groups=1),
        notes=("vocab 50280 padded to 51200 (25*2048)", "attention-free"),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-smoke",
        family="ssm",
        num_layers=4,
        d_model=64,
        num_heads=8,
        num_kv_heads=8,
        d_ff=0,
        vocab_size=512,
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16, n_groups=1, chunk_size=8),
    )
