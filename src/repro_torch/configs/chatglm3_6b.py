"""chatglm3-6b — 2D-RoPE (rotary on half the head dim), extreme GQA kv=2
[arXiv:2406.12793].

28L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=65024.
"""
from repro_torch.models.lm.config import ArchConfig

CONFIG = ArchConfig(
    name="chatglm3-6b",
    family="dense",
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    head_dim=128,
    d_ff=13696,
    vocab=65024,
    rope_frac=0.5,          # chatglm applies rotary to half the dims ("2d")
    optimizer="adamw",
    source="ChatGLM [arXiv:2406.12793]",
)
