"""Granite-3.0 MoE 3B-A800M [hf:ibm-granite/granite-3.0-1b-a400m-base
family, scaled per assignment].

moe, 32L, d_model=1536, 24H (GQA kv=8), expert d_ff=512, 40 experts top-8,
vocab=49155.  Tiny experts -> cheapest chunks, highest placement freedom.
"""
from repro_torch.common.config import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-3b-a800m", arch_type="moe", num_layers=32,
        d_model=1536, num_heads=24, num_kv_heads=8, head_dim=64,
        d_ff=512, vocab_size=49_155,
        moe=MoEConfig(num_experts=40, experts_per_token=8, d_ff=512,
                      slots_per_device=4),
        act="silu_glu", norm="rms", tie_embeddings=True,
        source="hf:ibm-granite/granite-3.0-1b-a400m-base")


def smoke() -> ModelConfig:
    return config().replace(
        name="granite-smoke", num_layers=2, d_model=256, num_heads=4,
        num_kv_heads=2, head_dim=64, d_ff=256,
        moe=MoEConfig(num_experts=4, experts_per_token=2, d_ff=256,
                      slots_per_device=2),
        vocab_size=512, remat=False, dtype="float32")
