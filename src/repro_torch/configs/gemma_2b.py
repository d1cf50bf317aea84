"""gemma-2b [dense] (arXiv:2403.08295; hf): GeGLU, head_dim=256, MQA.
18L d_model=2048 8H (kv=1) d_ff=16384 vocab=256000."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma-2b",
        family="dense",
        num_layers=18,
        d_model=2048,
        num_heads=8,
        num_kv_heads=1,
        head_dim=256,
        d_ff=16384,
        vocab_size=256000,
        activation="gelu",
        tie_embeddings=True,
        notes=(
            "vocab 256000 already a multiple of 2048; no padding",
            "MQA: kv_heads=1 cannot shard on model axis -> KV replicated; "
            "decode shards the cache on the sequence dim instead",
        ),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="gemma-2b-smoke",
        family="dense",
        num_layers=3,
        d_model=64,
        num_heads=4,
        num_kv_heads=1,
        head_dim=32,
        d_ff=128,
        vocab_size=500,
        activation="gelu",
        tie_embeddings=True,
    )
