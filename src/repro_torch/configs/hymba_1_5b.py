"""hymba-1.5b — parallel attention + mamba heads in every layer
[arXiv:2411.13676].

32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16.
Attention heads use a 1024-token sliding window (Hymba uses SWA in all but
three layers; we apply it uniformly — noted in DESIGN.md) => subquadratic,
runs long_500k.  25 heads are not divisible by the 16-way model axis, so
attention is replicated across `model` and parallelism comes from the FFN
and SSM d_inner (3200 = 16 x 200) — see launch/sharding.py.
"""
from repro_torch.models.lm.config import ArchConfig

CONFIG = ArchConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab=32001,
    ssm_state=16,
    ssm_head_dim=64,
    ssm_expand=2,
    window=1024,
    optimizer="adamw",
    source="Hymba [arXiv:2411.13676]",
)
