"""OLMoE-1B-7B — fine-grained MoE, 64 experts top-8 [arXiv:2409.02060].

moe, 16L, d_model=2048, 16H (MHA kv=16), expert d_ff=1024, vocab=50304.
The PRIMARY FSSDP target: many small experts, high routing churn.
"""
from repro_torch.common.config import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="olmoe-1b-7b", arch_type="moe", num_layers=16,
        d_model=2048, num_heads=16, num_kv_heads=16, head_dim=128,
        d_ff=1024, vocab_size=50_304,
        moe=MoEConfig(num_experts=64, experts_per_token=8, d_ff=1024,
                      slots_per_device=4,
                      # many small experts: re-gathering the (K, chunk)
                      # slots in the backward is cheaper than saving them
                      rematerialize="gather"),
        act="silu_glu", norm="rms", tie_embeddings=False,
        source="arXiv:2409.02060")


def smoke() -> ModelConfig:
    return config().replace(
        name="olmoe-smoke", num_layers=2, d_model=256, num_heads=4,
        num_kv_heads=4, head_dim=64, d_ff=256,
        moe=MoEConfig(num_experts=4, experts_per_token=2, d_ff=256,
                      slots_per_device=2),
        vocab_size=512, remat=False, dtype="float32")
