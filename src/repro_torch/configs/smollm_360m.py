"""SmolLM-360M — llama-arch small [hf:HuggingFaceTB/SmolLM-135M family].

dense, 32L, d_model=960, 15 heads (GQA kv=5), d_ff=2560, vocab=49152.
"""
from repro_torch.common.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="smollm-360m", arch_type="dense", num_layers=32,
        d_model=960, num_heads=15, num_kv_heads=5, head_dim=64,
        d_ff=2560, vocab_size=49_152, act="silu_glu", norm="rms",
        tie_embeddings=True, source="hf:HuggingFaceTB/SmolLM-135M")


def smoke() -> ModelConfig:
    return config().replace(
        name="smollm-smoke", num_layers=2, d_model=192, num_heads=3,
        num_kv_heads=1, head_dim=64, d_ff=384, vocab_size=512, remat=False,
        dtype="float32")
