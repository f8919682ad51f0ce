"""mistral-nemo-12b — 128k-context dense model
[hf:mistralai/Mistral-Nemo-Base-2407].

40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072, head_dim 128.
Full attention (no SWA in Nemo) => long_500k decode is skipped per the
sub-quadratic rule (DESIGN.md §5).
"""
from repro_torch.models.lm.config import ArchConfig

CONFIG = ArchConfig(
    name="mistral-nemo-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=131072,
    rope_theta=1e6,          # long-context rope base
    fsdp=True,
    optimizer="adamw",
    source="Mistral-Nemo [hf:mistralai/Mistral-Nemo-Base-2407]",
)
