"""llama-3.2-vision-90b [vlm] (hf:meta-llama; unverified tier):
100L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256, gated
cross-attention to image tokens every 5th layer (20 cross layers).
Vision frontend is a STUB: precomputed patch embeddings (B, 1024, d)."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-90b",
        family="vlm",
        num_layers=100,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        d_ff=28672,
        vocab_size=128256,
        rope_theta=500_000.0,
        cross_attn_period=5,
        num_image_tokens=1024,
        notes=(
            "vocab 128256 padded to 129024 (63*2048)",
            "100 layers = 20 groups of (4 self + 1 gated cross)",
            "vision frontend stubbed: precomputed patch embeddings",
        ),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llama-vision-smoke",
        family="vlm",
        num_layers=4,   # 2 groups of (1 self + 1 cross)
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        d_ff=128,
        vocab_size=512,
        cross_attn_period=2,
        num_image_tokens=16,
    )
