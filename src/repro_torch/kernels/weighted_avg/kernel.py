"""Launcher of the hand-written CUDA weighted_avg kernel
(`kernels/csrc/weighted_avg.cu`; counterpart of
`repro/kernels/weighted_avg/kernel.py`).

stacked (M, D) f32/bf16 x weights (R, M) of the same dtype -> (R, D) in
stacked's dtype, accumulated in float32 over k = 0 .. M-1.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import LAUNCHES, check_launch, library, stream_ptr

_ENTRY = {torch.float32: "weighted_avg_f32",
          torch.bfloat16: "weighted_avg_bf16"}
MAX_ROWS = 64              # weight rows staged per block
SMEM_FLOATS = 12 * 1024    # 48 KB of shared memory, the static limit


def rows_per_block(m: int) -> int:
    """Weight rows a block stages: at most 64, and rows * M floats fit in
    48 KB of shared memory."""
    return max(1, min(MAX_ROWS, SMEM_FLOATS // max(m, 1)))


def weighted_avg_cuda(stacked: torch.Tensor,
                      weights: torch.Tensor) -> torch.Tensor:
    """Launch the kernel once on PyTorch's current stream."""
    m, d = stacked.shape
    r = weights.shape[0]
    if stacked.dtype not in _ENTRY:
        raise TypeError(f"weighted_avg takes float32 or bfloat16, got "
                        f"{stacked.dtype}")
    if weights.dtype != stacked.dtype or weights.shape != (r, m):
        raise ValueError(f"weights must be {stacked.dtype} of shape ({r}, "
                         f"{m}), got {weights.dtype} {tuple(weights.shape)}")
    if m > SMEM_FLOATS:
        raise ValueError(f"weighted_avg takes at most {SMEM_FLOATS} models, "
                         f"got {m}")
    for name, t in (("stacked", stacked), ("weights", weights)):
        if t.device != stacked.device or not t.is_cuda:
            raise ValueError(f"{name} is on {t.device}, not on "
                             f"{stacked.device} (a CUDA device)")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    out = torch.empty((r, d), dtype=stacked.dtype, device=stacked.device)
    if out.numel() == 0:
        return out
    rows = rows_per_block(m)
    if -(-r // rows) > 65535:
        raise ValueError(f"weighted_avg takes at most {65535 * rows} weight "
                         f"rows at M = {m}, got {r}")
    rc = getattr(library(), _ENTRY[stacked.dtype])(
        stacked.data_ptr(), weights.data_ptr(), out.data_ptr(), r, m, d, rows,
        stacked.device.index, stream_ptr(stacked))
    check_launch(rc, "weighted_avg")
    LAUNCHES["weighted_avg"] += 1
    return out
