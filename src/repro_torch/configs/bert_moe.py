"""BERT-MoE (paper Table 1): d_model=1024, seq 512, 12L, 64 experts, 3.27B.

Bidirectional encoder trained with MLM in the paper; we train it as a
bidirectional encoder with the same per-layer cost profile (causal=False).
As in the JAX package, only ``build_train_step(..., causal=False)`` trains it
bidirectionally: ``train.trainer.train_loop`` and ``launch/train.py``
train it causally, as the reference's loop and launcher do.
"""
from repro_torch.common.config import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="bert-moe", arch_type="moe", num_layers=12,
        d_model=1024, num_heads=16, num_kv_heads=16, head_dim=64,
        d_ff=2048, vocab_size=30_592,
        moe=MoEConfig(num_experts=64, experts_per_token=2, d_ff=2048,
                      slots_per_device=4),
        act="gelu", norm="ln", tie_embeddings=True, source="Hecate Table 1")


def smoke() -> ModelConfig:
    return config().replace(
        name="bert-moe-smoke", num_layers=2, d_model=128, num_heads=4,
        num_kv_heads=4, head_dim=32, d_ff=256,
        moe=MoEConfig(num_experts=4, experts_per_token=2, d_ff=256,
                      slots_per_device=2),
        vocab_size=512, remat=False, dtype="float32")
