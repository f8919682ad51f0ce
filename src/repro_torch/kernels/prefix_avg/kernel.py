"""Launcher of the hand-written CUDA prefix_avg kernel
(`kernels/csrc/prefix_avg.cu`; counterpart of
`repro/kernels/prefix_avg/kernel.py`).

stacked (M, D) f32/bf16 x perms (R, M) int64 x scale, ncum (R, M) f32 ->
(R*M, D) in stacked's dtype: row r*M + j = S_j / N_j along walk r.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import LAUNCHES, check_launch, library, stream_ptr

_ENTRY = {torch.float32: "prefix_avg_f32", torch.bfloat16: "prefix_avg_bf16"}


def prefix_avg_cuda(stacked: torch.Tensor, perms: torch.Tensor,
                    scale: torch.Tensor, ncum: torch.Tensor) -> torch.Tensor:
    """Launch the kernel once on PyTorch's current stream."""
    m, d = stacked.shape
    r = perms.shape[0]
    if stacked.dtype not in _ENTRY:
        raise TypeError(f"prefix_avg takes float32 or bfloat16, got "
                        f"{stacked.dtype}")
    if perms.dtype != torch.int64 or perms.shape != (r, m):
        raise ValueError(f"perms must be int64 of shape ({r}, {m}), got "
                         f"{perms.dtype} {tuple(perms.shape)}")
    for name, t in (("scale", scale), ("ncum", ncum)):
        if t.dtype != torch.float32 or t.shape != (r, m):
            raise ValueError(f"{name} must be float32 of shape ({r}, {m})")
    for name, t in (("stacked", stacked), ("perms", perms), ("scale", scale),
                    ("ncum", ncum)):
        if t.device != stacked.device or not t.is_cuda:
            raise ValueError(f"{name} is on {t.device}, not on "
                             f"{stacked.device} (a CUDA device)")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    out = torch.empty((r * m, d), dtype=stacked.dtype, device=stacked.device)
    if out.numel() == 0:
        return out
    rc = getattr(library(), _ENTRY[stacked.dtype])(
        stacked.data_ptr(), perms.data_ptr(), scale.data_ptr(),
        ncum.data_ptr(), out.data_ptr(), r, m, d, stacked.device.index,
        stream_ptr(stacked))
    check_launch(rc, "prefix_avg")
    LAUNCHES["prefix_avg"] += 1
    return out
