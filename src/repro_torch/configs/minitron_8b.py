"""Minitron-8B — width-pruned Nemotron-4 [arXiv:2407.14679].

dense, 32L, d_model=4096, 32 heads (GQA kv=8), d_ff=16384, vocab=256000.
"""
from repro_torch.common.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="minitron-8b", arch_type="dense", num_layers=32,
        d_model=4096, num_heads=32, num_kv_heads=8, head_dim=128,
        d_ff=16384, vocab_size=256_000, act="silu_glu", norm="rms",
        tie_embeddings=False, rope_theta=10_000.0,
        source="arXiv:2407.14679")


def smoke() -> ModelConfig:
    return config().replace(
        name="minitron-8b-smoke", num_layers=2, d_model=256, num_heads=4,
        num_kv_heads=2, head_dim=64, d_ff=512, vocab_size=512, remat=False,
        dtype="float32")
