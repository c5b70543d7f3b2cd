"""Qwen2-VL-72B — M-RoPE, dynamic resolution [arXiv:2409.12191].

vlm, 80L, d_model=8192, 64H (GQA kv=8), d_ff=29568, vocab=152064.
The ViT/projector frontend is a stub, as in the JAX package:
``forward(embeds=...)`` takes precomputed patch+text embeddings (and the
train step a batch of ``embeds`` and ``labels``); this config is the LM
backbone.
"""
from repro_torch.common.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-72b", arch_type="vlm", num_layers=80,
        d_model=8192, num_heads=64, num_kv_heads=8, head_dim=128,
        d_ff=29_568, vocab_size=152_064, qkv_bias=True, mrope=True,
        frontend="vision", act="silu_glu", norm="rms",
        tie_embeddings=False, rope_theta=1_000_000.0,
        source="arXiv:2409.12191")


def smoke() -> ModelConfig:
    return config().replace(
        name="qwen2vl-smoke", num_layers=2, d_model=256, num_heads=4,
        num_kv_heads=2, head_dim=64, d_ff=512, vocab_size=512, remat=False,
        dtype="float32")
