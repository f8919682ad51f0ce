"""The LM families of the port (counterpart of `repro/models/lm`)."""
from repro_torch.models.lm.config import (
    ArchConfig, active_param_count, param_count,
)
from repro_torch.models.lm.model import (
    decode_step, forward, init_cache, init_params, prefill_step,
)

__all__ = [
    "ArchConfig", "param_count", "active_param_count",
    "init_params", "forward", "init_cache", "prefill_step", "decode_step",
]
