"""Plain PyTorch version of the ce_loss kernel (counterpart of
`repro/kernels/ce_loss/ref.py`)."""
from __future__ import annotations

import torch


def ce_loss_ref(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """(..., R, V) x (R,) -> per-row CE (..., R) float32; every leading
    index is scored against the same R labels."""
    lg = logits.to(torch.float32)
    logz = torch.logsumexp(lg, dim=-1)
    idx = labels.to(torch.int64).expand(lg.shape[:-1])[..., None]
    return logz - torch.gather(lg, -1, idx)[..., 0]
