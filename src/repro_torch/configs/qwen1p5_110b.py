"""Qwen1.5-110B — QKV bias [hf:Qwen/Qwen1.5-0.5B, scaled per assignment].

dense, 80L, d_model=8192, 64 heads (GQA kv=8), d_ff=49152, vocab=152064.
"""
from repro_torch.common.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-110b", arch_type="dense", num_layers=80,
        d_model=8192, num_heads=64, num_kv_heads=8, head_dim=128,
        d_ff=49_152, vocab_size=152_064, qkv_bias=True,
        act="silu_glu", norm="rms", tie_embeddings=False,
        rope_theta=1_000_000.0, source="hf:Qwen/Qwen1.5-0.5B")


def smoke() -> ModelConfig:
    return config().replace(
        name="qwen1.5-smoke", num_layers=2, d_model=256, num_heads=4,
        num_kv_heads=2, head_dim=64, d_ff=512, vocab_size=512, remat=False,
        dtype="float32")
