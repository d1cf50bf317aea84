"""glm4-9b [dense] (hf:THUDM/glm-4-9b): RoPE, GQA.
40L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=151552."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="glm4-9b",
        family="dense",
        num_layers=40,
        d_model=4096,
        num_heads=32,
        num_kv_heads=2,
        d_ff=13696,
        vocab_size=151552,
        notes=("vocab 151552 = 74*2048; no padding",),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="glm4-smoke",
        family="dense",
        num_layers=3,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        d_ff=192,
        vocab_size=512,
    )
