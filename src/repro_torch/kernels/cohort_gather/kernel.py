"""Launcher of the hand-written CUDA cohort_gather kernel
(`kernels/csrc/cohort_gather.cu`; counterpart of
`repro/kernels/cohort_gather/kernel.py`).

table (N, D) of any dtype x ids (M,) int64 -> (M, D): a raw copy of the
selected rows.  An id outside [0, N) raises `IndexError` after the launch
(the kernel flags it on the device instead of reading out of bounds).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import LAUNCHES, check_launch, library, stream_ptr


def cohort_gather_cuda(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Launch the kernel once on PyTorch's current stream."""
    n = table.shape[0]
    (m,) = ids.shape
    if table.dim() != 2:
        raise ValueError(f"table must be 2-D, got {tuple(table.shape)}")
    if ids.dtype != torch.int64:
        raise ValueError(f"ids must be int64, got {ids.dtype}")
    for name, t in (("table", table), ("ids", ids)):
        if t.device != table.device or not t.is_cuda:
            raise ValueError(f"{name} is on {t.device}, not on "
                             f"{table.device} (a CUDA device)")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    out = torch.empty((m, table.shape[1]), dtype=table.dtype,
                      device=table.device)
    if out.numel() == 0:
        return out
    bad = torch.zeros((1,), dtype=torch.int32, device=table.device)
    rc = library().cohort_gather(
        table.data_ptr(), ids.data_ptr(), out.data_ptr(), bad.data_ptr(), n,
        m, table.shape[1] * table.element_size(), table.device.index,
        stream_ptr(table))
    check_launch(rc, "cohort_gather")
    LAUNCHES["cohort_gather"] += 1
    if int(bad.item()):
        raise IndexError(f"cohort ids must index [0, {n}); the kernel found "
                         "one outside and read nothing for it")
    return out
