"""seamless-m4t-large-v2 [audio enc-dec] (arXiv:2308.11596; hf).

24L d_model=1024 16H (kv=16) d_ff=8192 vocab=256206. Interpreted as a
24-layer speech encoder + 24-layer text decoder (SeamlessM4T-Large v2's
symmetric backbone). The audio frontend is a STUB per the brief:
``input_specs`` provides precomputed frame embeddings (B, 1024, d_model).
Adaptation note: RoPE replaces the original sinusoidal/relative positions
(recorded in DESIGN.md); this does not change shapes or cost terms.
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-large-v2",
        family="encdec",
        num_layers=24,
        encoder_layers=24,
        d_model=1024,
        num_heads=16,
        num_kv_heads=16,
        d_ff=8192,
        vocab_size=256206,
        activation="gelu",
        source_len=1024,
        notes=(
            "vocab 256206 padded to 258048 (126*2048); padded logits masked",
            "RoPE substituted for sinusoidal positions (TPU-native choice)",
            "audio frontend stubbed: precomputed frame embeddings",
        ),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-smoke",
        family="encdec",
        num_layers=2,
        encoder_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        d_ff=128,
        vocab_size=503,
        activation="gelu",
        source_len=24,
    )
