"""tinyllama-1.1b — llama2-architecture small model [arXiv:2401.02385].

22L d_model=2048 32H (GQA kv=4) d_ff=5632 vocab=32000, head_dim 64.
"""
from repro_torch.models.lm.config import ArchConfig

CONFIG = ArchConfig(
    name="tinyllama-1.1b",
    family="dense",
    n_layers=22,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=64,
    d_ff=5632,
    vocab=32000,
    optimizer="adamw",
    source="TinyLlama [arXiv:2401.02385]",
)
