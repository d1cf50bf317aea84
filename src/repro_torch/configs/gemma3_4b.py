"""gemma3-4b [dense] (hf:google/gemma-3 family; unverified tier):
34L d_model=2560 8H (GQA kv=4) d_ff=10240 vocab=262144, 5:1 local:global
sliding-window attention (window 1024), 128k context. long_500k runs:
only the ~5 global layers hold full-length KV; locals use ring caches."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-4b",
        family="dense",
        num_layers=34,
        d_model=2560,
        num_heads=8,
        num_kv_heads=4,
        head_dim=256,
        d_ff=10240,
        vocab_size=262144,
        activation="gelu",
        tie_embeddings=True,
        sliding_window=1024,
        global_period=6,   # every 6th layer global => 5:1 local:global
        rope_theta=1_000_000.0,
        notes=(
            "vocab 262144 = 128*2048; no padding",
            "34 layers = 5 groups of (5 local + 1 global) + 4 local tail",
        ),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-smoke",
        family="dense",
        num_layers=7,          # 2 groups of (2 local + 1 global) + 1 tail
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=499,
        activation="gelu",
        tie_embeddings=True,
        sliding_window=8,
        global_period=3,
    )
