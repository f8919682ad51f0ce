"""whisper-medium — encoder-decoder ASR backbone [arXiv:2212.04356].

24L (encoder) + 24L (decoder), d_model=1024 16H (kv=16, i.e. MHA)
d_ff=4096 vocab=51865, GELU MLP + LayerNorm, sinusoidal positions (no
RoPE: rope_frac=0).  The mel-spectrogram + conv feature extractor is a
STUB per the assignment carve-out: input_specs() supplies 1500 precomputed
frame embeddings consumed by the encoder.
"""
from repro_torch.models.lm.config import ArchConfig

CONFIG = ArchConfig(
    name="whisper-medium",
    family="audio",
    n_layers=24,
    encoder_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab=51865,
    ffn_kind="gelu",
    norm_kind="layer",
    rope_frac=0.0,
    frontend="audio",
    n_frontend_tokens=1500,
    optimizer="adamw",
    source="Whisper [arXiv:2212.04356]",
)
