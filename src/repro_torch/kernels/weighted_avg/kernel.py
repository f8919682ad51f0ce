"""Launcher of the hand-written CUDA weighted_avg kernel
(`kernels/csrc/weighted_avg.cu`; counterpart of
`repro/kernels/weighted_avg/kernel.py`).

A list of contiguous stacks (M, ...) of one dtype, f32 or bf16, x weights
(R, M) of that dtype -> a list of (R, ...) in that dtype, each accumulated
in float32 over k = 0 .. M-1.  One launch covers up to MAX_LEAVES stacks: the
wrapper passes the kernel a table of leaves by value (`launch_plan`).
"""
from __future__ import annotations

from math import prod
from typing import NamedTuple, Sequence

import torch

from repro_torch.kernels import (
    LAUNCHES, check_launch, host_table, library, stream_ptr,
)

_ENTRY = {torch.float32: "weighted_avg_f32",
          torch.bfloat16: "weighted_avg_bf16"}
THREADS = 256              # csrc/common.cuh::kWordThreads
WORD_BYTES = 16            # a thread's columns on the wide path
MAX_LEAVES = 32            # csrc/common.cuh::kMaxWordLeaves
MAX_ROWS = 64              # weight rows staged per block
SMEM_FLOATS = 12 * 1024    # 48 KB of shared memory, the static limit


class LeafPlan(NamedTuple):
    vec: int       # columns per thread: a 16-byte word's elements, or 1
    blk0: int      # first column block of the leaf in the launch's grid.x
    blocks: int    # column blocks of the leaf


def rows_per_block(m: int) -> int:
    """Weight rows a block stages: at most 64, and rows * M floats fit in
    48 KB of shared memory."""
    return max(1, min(MAX_ROWS, SMEM_FLOATS // max(m, 1)))


def launch_plan(leaves: Sequence[tuple[int, int, int]],
                itemsize: int) -> tuple[list[LeafPlan], int]:
    """Per (D, stack pointer, output pointer) leaf, its vector width (a
    16-byte word per thread where every row of the stack and of the output
    starts on a 16-byte boundary, else one column per thread) and its run
    of column blocks of THREADS threads, laid one after the other along
    grid.x; and the total number of column blocks."""
    plans, blk0 = [], 0
    word = WORD_BYTES // itemsize
    for d, src_ptr, out_ptr in leaves:
        wide = d % word == 0 and src_ptr % WORD_BYTES == 0 \
            and out_ptr % WORD_BYTES == 0
        vec = word if wide else 1
        blocks = -(-d // (THREADS * vec))
        plans.append(LeafPlan(vec, blk0, blocks))
        blk0 += blocks
    return plans, blk0


def weighted_avg_cuda(stacks: Sequence[torch.Tensor],
                      weights: torch.Tensor) -> list[torch.Tensor]:
    """Average every (M, ...) stack with the (R, M) weights, in one launch
    per MAX_LEAVES stacks on PyTorch's current stream."""
    r, m = weights.shape
    dtype = weights.dtype
    if dtype not in _ENTRY:
        raise TypeError(f"weighted_avg takes float32 or bfloat16, got {dtype}")
    if m > SMEM_FLOATS:
        raise ValueError(f"weighted_avg takes at most {SMEM_FLOATS} models, "
                         f"got {m}")
    for s in stacks:
        if s.dtype != dtype or s.dim() == 0 or s.shape[0] != m:
            raise ValueError(f"each stack must be {dtype} with M = {m} rows, "
                             f"the weights' columns; got {s.dtype} "
                             f"{tuple(s.shape)}")
    dev = weights.get_device()
    for name, t in (("weights", weights), *(("stack", s) for s in stacks)):
        if not t.is_cuda or t.get_device() != dev:
            raise ValueError(f"{name} is on {t.device}, not on "
                             f"{weights.device} (a CUDA device)")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    outs = [torch.empty((r,) + s.shape[1:], dtype=dtype, device=s.device)
            for s in stacks]
    rows = rows_per_block(m)
    if -(-r // rows) > 65535:
        raise ValueError(f"weighted_avg takes at most {65535 * rows} weight "
                         f"rows at M = {m}, got {r}")
    work = [(s, o) for s, o in zip(stacks, outs) if o.numel()]
    for i in range(0, len(work), MAX_LEAVES):
        rc = getattr(library(), _ENTRY[dtype])(
            *c_args(work[i:i + MAX_LEAVES], weights, rows))
        check_launch(rc, "weighted_avg")
        LAUNCHES["weighted_avg"] += 1
    return outs


def c_args(work: Sequence[tuple[torch.Tensor, torch.Tensor]],
           weights: torch.Tensor, rows: int) -> tuple:
    """The C entry's arguments for (stack, output) pairs."""
    r, m = weights.shape
    leaves = [(prod(s.shape[1:]), s.data_ptr(), o.data_ptr())
              for s, o in work]
    plans, blocks_x = launch_plan(leaves, weights.element_size())
    fields = []
    for (d, src, out), p in zip(leaves, plans):
        fields += (src, out, d, p.blk0, p.vec)
    return (host_table(fields), len(work), weights.data_ptr(), r, m, rows,
            blocks_x, weights.get_device(), stream_ptr(weights))
