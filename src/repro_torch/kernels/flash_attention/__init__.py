from repro_torch.kernels.flash_attention.ops import (
    FlashAttentionFn, attention_bwd_gqa_ref, flash_attention,
    flash_attention_gqa,
)
from repro_torch.kernels.flash_attention.ref import (
    attention_bwd_bf16_ref, attention_bwd_bf16_slack, attention_bwd_ref,
    attention_ref,
)

__all__ = ["FlashAttentionFn", "attention_bwd_bf16_ref",
           "attention_bwd_bf16_slack",
           "attention_bwd_gqa_ref", "attention_bwd_ref", "attention_ref",
           "flash_attention", "flash_attention_gqa"]
