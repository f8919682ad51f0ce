"""Launcher of the hand-written CUDA ce_loss kernel (`kernels/csrc/
ce_loss.cu`; counterpart of `repro/kernels/ce_loss/kernel.py`).

logits (rows, V) f32/bf16 x labels (L,) int64 with rows % L == 0 ->
per-row CE (rows,) f32, row i scored against labels[i % L].
"""
from __future__ import annotations

import torch

from repro_torch.kernels import LAUNCHES, check_launch, library, stream_ptr

_ENTRY = {torch.float32: "ce_loss_f32", torch.bfloat16: "ce_loss_bf16"}


def block_threads(v: int) -> int:
    """Threads per row-block: about eight logits each, 32..256."""
    want = -(-v // 8)
    return min(256, max(32, -(-want // 32) * 32))


def ce_loss_cuda(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Launch the kernel once on PyTorch's current stream."""
    rows, v = logits.shape
    n_labels = labels.shape[0]
    if logits.dtype not in _ENTRY:
        raise TypeError(f"ce_loss takes float32 or bfloat16 logits, got "
                        f"{logits.dtype}")
    if labels.dtype != torch.int64 or labels.dim() != 1:
        raise ValueError("labels must be a 1-D int64 tensor")
    if n_labels == 0 or rows % n_labels:
        raise ValueError(f"{rows} rows do not tile {n_labels} labels")
    for name, t in (("logits", logits), ("labels", labels)):
        if t.device != logits.device or not t.is_cuda:
            raise ValueError(f"{name} is on {t.device}, not on "
                             f"{logits.device} (a CUDA device)")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    out = torch.empty((rows,), dtype=torch.float32, device=logits.device)
    if rows == 0:
        return out
    if v == 0:
        raise ValueError("ce_loss needs at least one class")
    rc = getattr(library(), _ENTRY[logits.dtype])(
        logits.data_ptr(), labels.data_ptr(), out.data_ptr(), rows, v,
        n_labels, block_threads(v), logits.device.index, stream_ptr(logits))
    check_launch(rc, "ce_loss")
    LAUNCHES["ce_loss"] += 1
    return out
