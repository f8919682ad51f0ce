"""internvl2-76b — InternViT + InternLM2 VLM [arXiv:2404.16821].

Backbone (this config): 80L d_model=8192 64H (GQA kv=8) d_ff=28672
vocab=128256.  The InternViT vision encoder + MLP projector is a STUB per
the assignment carve-out: input_specs() supplies 256 precomputed patch
embeddings of width d_model which replace the first 256 token positions.
"""
from repro_torch.models.lm.config import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-76b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab=128256,
    frontend="vision",
    n_frontend_tokens=256,
    fsdp=True,
    optimizer="adamw",
    source="InternVL2 [arXiv:2404.16821]",
)
