"""Whisper-medium — encoder-decoder speech model [arXiv:2212.04356].

audio, 24 encoder + 24 decoder layers, d_model=1024, 16H (MHA kv=16),
d_ff=4096, vocab=51865.  The mel+conv frontend is a stub, as in the JAX
package: ``forward(encoder_input=...)`` takes precomputed 1500-frame
embeddings.  The decoder context is capped at 448 tokens
(``max_decoder_len``).
"""
from repro_torch.common.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-medium", arch_type="audio", num_layers=24,
        d_model=1024, num_heads=16, num_kv_heads=16, head_dim=64,
        d_ff=4096, vocab_size=51_865, is_encoder_decoder=True,
        encoder_layers=24, encoder_seq_len=1500, max_decoder_len=448,
        frontend="audio", act="gelu", norm="ln", tie_embeddings=True,
        source="arXiv:2212.04356")


def smoke() -> ModelConfig:
    return config().replace(
        name="whisper-smoke", num_layers=2, encoder_layers=2, d_model=256,
        num_heads=4, num_kv_heads=4, head_dim=64, d_ff=512, vocab_size=512,
        encoder_seq_len=32, max_decoder_len=64, remat=False,
        dtype="float32")
