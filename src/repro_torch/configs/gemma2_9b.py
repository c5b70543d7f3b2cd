"""Gemma-2 9B — local/global alternating attention, logit softcaps
[arXiv:2408.00118].

dense, 42L, d_model=3584, 16H (GQA kv=8), d_ff=14336, vocab=256000,
sliding_window=4096, attn softcap 50, final softcap 30, GeGLU.
"""
from repro_torch.common.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-9b", arch_type="dense", num_layers=42,
        d_model=3584, num_heads=16, num_kv_heads=8, head_dim=256,
        d_ff=14_336, vocab_size=256_000,
        layer_pattern=("local", "attn"), sliding_window=4096,
        attn_logit_softcap=50.0, final_logit_softcap=30.0,
        act="gelu_glu", norm="rms", tie_embeddings=True,
        source="arXiv:2408.00118")


def smoke() -> ModelConfig:
    return config().replace(
        name="gemma2-smoke", num_layers=4, d_model=256, num_heads=4,
        num_kv_heads=2, head_dim=64, d_ff=512, vocab_size=512,
        sliding_window=32, remat=False, dtype="float32")
