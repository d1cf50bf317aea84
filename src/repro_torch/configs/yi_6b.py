"""yi-6b [dense] (arXiv:2403.04652; hf): llama-arch GQA.
32L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="yi-6b",
        family="dense",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=4,
        d_ff=11008,
        vocab_size=64000,
        rope_theta=5_000_000.0,
        notes=("vocab 64000 padded to 65536 (32*2048)",),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="yi-smoke",
        family="dense",
        num_layers=3,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        d_ff=160,
        vocab_size=509,
        rope_theta=5_000_000.0,
    )
