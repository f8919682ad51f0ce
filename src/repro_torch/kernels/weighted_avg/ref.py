"""Plain PyTorch version of the weighted_avg kernel (counterpart of
`repro/kernels/weighted_avg/ref.py`)."""
from __future__ import annotations

import torch


def weighted_avg_ref(stacked: torch.Tensor,
                     weights: torch.Tensor) -> torch.Tensor:
    """stacked (M, D) x weights (R, M) -> (R, D) in f32 accumulation."""
    out = torch.einsum("rm,md->rd", weights.to(torch.float32),
                       stacked.to(torch.float32))
    return out.to(stacked.dtype)
