"""Jamba-v0.1-52B — hybrid Mamba+attention 1:7, MoE 16e top-2
[arXiv:2403.19887].

32L: one attention layer per 8 (position 4 of each period-8 block),
MoE every other layer.  d_model=4096, 32H (GQA kv=8), experts d_ff=14336,
vocab=65536.
"""
from repro_torch.common.config import ModelConfig, MoEConfig, SSMConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="jamba-v0.1-52b", arch_type="hybrid", num_layers=32,
        d_model=4096, num_heads=32, num_kv_heads=8, head_dim=128,
        d_ff=14_336, vocab_size=65_536,
        layer_pattern=("mamba", "mamba", "mamba", "mamba",
                       "attn", "mamba", "mamba", "mamba"),
        moe=MoEConfig(num_experts=16, experts_per_token=2, d_ff=14_336,
                      period=2, offset=1, slots_per_device=2),
        ssm=SSMConfig(state_dim=16, head_dim=64, expand=2, conv_width=4,
                      chunk=256),
        act="silu_glu", norm="rms", tie_embeddings=False,
        source="arXiv:2403.19887")


def smoke() -> ModelConfig:
    return config().replace(
        name="jamba-smoke", num_layers=8, d_model=256, num_heads=4,
        num_kv_heads=2, head_dim=64, d_ff=512,
        moe=MoEConfig(num_experts=4, experts_per_token=2, d_ff=512,
                      period=2, offset=1, slots_per_device=2),
        ssm=SSMConfig(state_dim=16, head_dim=32, expand=2, conv_width=4,
                      chunk=16),
        vocab_size=512, remat=False, dtype="float32")
