"""GPT-MoE-L (paper Table 1): d_model=1536, seq 2048, 12L, 64 experts, 7.36B.

Experts are FFNs with d_ffn = 2*d_model (paper §5.1), GShard top-2 gate.
"""
from repro_torch.common.config import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gpt-moe-l", arch_type="moe", num_layers=12,
        d_model=1536, num_heads=16, num_kv_heads=16, head_dim=96,
        d_ff=3072, vocab_size=50_304,
        moe=MoEConfig(num_experts=64, experts_per_token=2, d_ff=3072,
                      slots_per_device=4,
                      # 7.36B: chunk residuals dominate HBM at train_4k —
                      # re-gather them in the backward (paper §4.3)
                      rematerialize="gather"),
        act="gelu", norm="ln", tie_embeddings=True, source="Hecate Table 1")


def smoke() -> ModelConfig:
    return config().replace(
        name="gpt-moe-l-smoke", num_layers=2, d_model=128, num_heads=4,
        num_kv_heads=4, head_dim=32, d_ff=256,
        moe=MoEConfig(num_experts=4, experts_per_token=2, d_ff=256,
                      slots_per_device=2),
        vocab_size=512, remat=False, dtype="float32")
