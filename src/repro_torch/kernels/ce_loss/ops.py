"""Public wrapper for the fused CE utility evaluation (counterpart of
`repro/kernels/ce_loss/ops.py`).

CUDA logits go to the CUDA kernel at any vocabulary size (it needs no
vocab tile, so the reference's V < 2048 cut-over to its ref has no
counterpart on the card); CPU logits go to the plain version.  The card's
path checks the labels' range first, which reads the card back;
`checked=True` skips that read for labels the caller checked where it
made them (a captured round reads nothing back).  Meta logits get an
empty loss of the kernel's shape, nothing checked or computed.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import counted, use_kernel
from repro_torch.kernels.ce_loss.kernel import ce_loss_cuda
from repro_torch.kernels.ce_loss.ref import ce_loss_ref


def ce_loss(logits: torch.Tensor, labels: torch.Tensor, *,
            checked: bool = False) -> torch.Tensor:
    """Mean CE over rows: (..., R, V) logits, (R,) int labels -> (...) f32.

    A 2-D input gives the reference's scalar; a leading model axis scores
    every model on the same R rows in one launch.
    """
    r, v = logits.shape[-2:]
    if labels.shape != (r,):
        raise ValueError(f"labels must have shape ({r},), got "
                         f"{tuple(labels.shape)}")
    with counted("ce_loss", models=logits.numel() // max(r * v, 1), rows=r,
                 v=v, itemsize=logits.element_size()):
        if not use_kernel(logits):
            return torch.mean(ce_loss_ref(logits, labels), dim=-1)
        if logits.is_meta:
            per = logits.new_empty(logits.shape[:-1], dtype=torch.float32)
        else:
            if not checked:
                check_labels(labels, v)
            per = ce_loss_cuda(logits.reshape(-1, v).contiguous(),
                               labels.to(torch.int64).contiguous())
        return torch.mean(per.reshape(logits.shape[:-1]), dim=-1)


def check_labels(labels: torch.Tensor, v: int) -> None:
    """Raise ValueError unless every label indexes [0, V) (one read of the
    labels' range)."""
    if not labels.numel():
        return
    lo, hi = torch.aminmax(labels)
    if int(lo) < 0 or int(hi) >= v:
        raise ValueError(f"labels must index [0, {v}), got [{int(lo)}, "
                         f"{int(hi)}]")
