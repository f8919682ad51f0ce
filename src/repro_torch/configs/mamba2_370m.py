"""mamba2-370m — SSD (state-space duality) [arXiv:2405.21060].

48L d_model=1024, attention-free, d_ff=0, vocab=50280, ssm_state=128.
d_inner = 2*1024 = 2048, P=64 => 32 SSD heads.
"""
from repro_torch.models.lm.config import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=50280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=256,
    optimizer="adamw",
    source="SSD / Mamba2 [arXiv:2405.21060]",
)
