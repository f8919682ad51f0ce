"""qwen3-moe-30b-a3b — 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B].

48L d_model=2048 32H (GQA kv=4) per-expert d_ff=768 vocab=151936.
"""
from repro_torch.models.lm.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=768,               # per-expert width
    vocab=151936,
    n_experts=128,
    top_k=8,
    capacity_factor=1.25,
    fsdp=True,
    optimizer="adamw",
    source="Qwen3-30B-A3B [hf:Qwen/Qwen3-30B-A3B]",
)
