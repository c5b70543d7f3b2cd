"""Mamba2-1.3B — SSD / state-space duality [arXiv:2405.21060].

ssm (attention-free), 48L, d_model=2048, vocab=50280, ssm_state=128.
"""
from repro_torch.common.config import ModelConfig, SSMConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-1.3b", arch_type="ssm", num_layers=48,
        d_model=2048, num_heads=1, num_kv_heads=1, head_dim=64, d_ff=0,
        vocab_size=50_280, layer_pattern=("mamba",),
        ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, conv_width=4,
                      chunk=256),
        act="silu_glu", norm="rms", tie_embeddings=True,
        source="arXiv:2405.21060")


def smoke() -> ModelConfig:
    return config().replace(
        name="mamba2-smoke", num_layers=2, d_model=256, vocab_size=512,
        ssm=SSMConfig(state_dim=32, head_dim=32, expand=2, conv_width=4,
                      chunk=16),
        remat=False, dtype="float32")
