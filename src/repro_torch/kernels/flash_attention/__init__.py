from repro_torch.kernels.flash_attention.ops import (
    flash_attention, flash_attention_gqa,
)
from repro_torch.kernels.flash_attention.ref import attention_ref

__all__ = ["flash_attention", "flash_attention_gqa", "attention_ref"]
