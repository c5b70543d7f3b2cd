"""GPT-MoE-S (paper Table 1): d_model=768, seq 2048, 12L, 64 experts, 1.84B.

Experts are FFNs with d_ffn = 2*d_model (paper §5.1), GShard top-2 gate.
"""
from repro_torch.common.config import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gpt-moe-s", arch_type="moe", num_layers=12,
        d_model=768, num_heads=12, num_kv_heads=12, head_dim=64,
        d_ff=1536, vocab_size=50_304,
        moe=MoEConfig(num_experts=64, experts_per_token=2, d_ff=1536,
                      slots_per_device=4),
        act="gelu", norm="ln", tie_embeddings=True, source="Hecate Table 1")


def smoke() -> ModelConfig:
    return config().replace(
        name="gpt-moe-s-smoke", num_layers=2, d_model=128, num_heads=4,
        num_kv_heads=4, head_dim=32, d_ff=256,
        moe=MoEConfig(num_experts=4, experts_per_token=2, d_ff=256,
                      slots_per_device=2),
        vocab_size=512, remat=False, dtype="float32")
