"""Launcher of the hand-written CUDA delta_codec kernel
(`kernels/csrc/delta_codec.cu`; counterpart of
`repro/kernels/delta_codec/kernel.py`).

x (rows, d) float32 -> (rows, d) float32, each row roundtripped through
`codec`; `k` is the per-row keep count of the sparse codecs.  The kernel
masks the ragged edge itself, so there is no padding and no `d_true`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import LAUNCHES, check_launch, library, stream_ptr
from repro_torch.kernels.delta_codec.ref import CODEC_IDS


def delta_codec_cuda(x: torch.Tensor, codec: str, k: int = 0) -> torch.Tensor:
    """Launch the kernel once on PyTorch's current stream."""
    if codec not in CODEC_IDS:
        raise ValueError(f"unknown delta codec {codec!r}")
    if x.dtype != torch.float32 or x.dim() != 2:
        raise TypeError(f"delta_codec takes a 2-D float32 matrix, got "
                        f"{x.dtype} {tuple(x.shape)}")
    if not x.is_cuda:
        raise ValueError(f"x is on {x.device}, not on a CUDA device")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    rows, d = x.shape
    if codec != "quant8" and not 1 <= k <= d:
        raise ValueError(f"k must be in [1, {d}], got {k}")
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    rc = library().delta_codec_f32(
        x.data_ptr(), out.data_ptr(), rows, d, CODEC_IDS[codec], k,
        x.device.index, stream_ptr(x))
    check_launch(rc, "delta_codec")
    LAUNCHES["delta_codec"] += 1
    return out
