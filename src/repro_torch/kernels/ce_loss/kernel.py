"""Launcher of the hand-written CUDA ce_loss kernel (`kernels/csrc/
ce_loss.cu`; counterpart of `repro/kernels/ce_loss/kernel.py`).

logits (rows, V) f32/bf16 x labels (L,) int64 with rows % L == 0 ->
per-row CE (rows,) f32, row i scored against labels[i % L].
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import LAUNCHES, check_launch, library, stream_ptr

_ENTRY = {torch.float32: "ce_loss_f32", torch.bfloat16: "ce_loss_bf16"}
THREADS = 256          # every variant's block (csrc/ce_loss.cu::kThreads)
ROWS_MAX_V = 32        # up to here whole rows per thread
WARP_MAX_V = 4096      # up to here one warp per row; above, one block per row
BLOCKS_PER_SM = 8
VARIANTS = ("rows", "warp", "block")   # the C entry's variant codes 0, 1, 2


class LaunchPlan(NamedTuple):
    variant: str
    blocks: int


def launch_plan(rows: int, v: int, n_sms: int = 132) -> LaunchPlan:
    """The variant for V and a persistent grid of 256-thread blocks: at
    most BLOCKS_PER_SM blocks per SM, and never more blocks than units of
    work (256-row chunks, groups of 8 rows for 8 warps, or rows)."""
    if v <= ROWS_MAX_V:
        variant, work = "rows", -(-rows // THREADS)
    elif v <= WARP_MAX_V:
        variant, work = "warp", -(-rows // (THREADS // 32))
    else:
        variant, work = "block", rows
    return LaunchPlan(variant, max(1, min(work, n_sms * BLOCKS_PER_SM)))


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


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
    plan = launch_plan(rows, v, _sm_count(logits.device))
    rc = getattr(library(), _ENTRY[logits.dtype])(
        logits.data_ptr(), labels.data_ptr(), out.data_ptr(), rows, v,
        n_labels, VARIANTS.index(plan.variant), plan.blocks,
        logits.device.index, stream_ptr(logits))
    check_launch(rc, "ce_loss")
    LAUNCHES["ce_loss"] += 1
    return out
