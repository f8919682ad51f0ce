"""kimi-k2-1t-a32b — trillion-parameter MoE (paper-table spec)
[arXiv:2501.kimi2].

61L d_model=7168 64H (GQA kv=8) per-expert d_ff=2048 vocab=163840,
MoE 384 experts top-8.  ~1.04T total params, ~32B active.

Distribution: FSDP over the data axis + expert parallelism over the model
axis; SGD-momentum optimizer (the paper's client optimizer — and the only
first-order state that fits 256 x 16 GB HBM at this scale; see
EXPERIMENTS.md §Dry-run for the memory ledger).
"""
from repro_torch.models.lm.config import ArchConfig

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=2048,              # per-expert width
    vocab=163840,
    n_experts=384,
    top_k=8,
    capacity_factor=1.25,
    fsdp=True,
    optimizer="sgd",
    source="Kimi K2 [arXiv:2501.kimi2]",
)
