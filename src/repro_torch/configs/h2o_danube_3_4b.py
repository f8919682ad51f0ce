"""h2o-danube-3-4b — llama+mistral mix with sliding-window attention
[arXiv:2401.16818].

24L d_model=3840 32H (GQA kv=8) d_ff=10240 vocab=32000; head_dim 120.
SWA window 4096 (mistral-style local attention) => subquadratic decode,
so this dense arch DOES run long_500k (DESIGN.md §5).
"""
from repro_torch.models.lm.config import ArchConfig

CONFIG = ArchConfig(
    name="h2o-danube-3-4b",
    family="dense",
    n_layers=24,
    d_model=3840,
    n_heads=32,
    n_kv_heads=8,
    head_dim=120,
    d_ff=10240,
    vocab=32000,
    window=4096,
    rope_theta=10000.0,
    optimizer="adamw",
    source="H2O-Danube 3 [arXiv:2401.16818]",
)
