"""Launcher of the hand-written CUDA prefix_avg kernel
(`kernels/csrc/prefix_avg.cu`; counterpart of
`repro/kernels/prefix_avg/kernel.py`).

A list of contiguous (M, ...) stacks of one dtype, f32 or bf16, x perms
(R, M) int64 x n_k (M,) f32 -> a list of (R*M, ...) in that dtype: row
r*M + j = S_j / N_j along walk r, both running sums in float32 strictly
left to right.  The kernel forms each walk's weights n_k[perm] and running
sizes N_j itself.  One launch covers up to MAX_LEAVES stacks: the wrapper
passes the kernel a table of leaves by value, laid out as weighted_avg's
(`launch_plan`).
"""
from __future__ import annotations

from math import prod
from typing import Sequence

import torch

from repro_torch.kernels import (
    LAUNCHES, check_launch, host_table, library, stream_ptr,
)
from repro_torch.kernels.weighted_avg.kernel import LeafPlan, MAX_LEAVES
from repro_torch.kernels.weighted_avg.kernel import launch_plan as word_plan

_ENTRY = {torch.float32: "prefix_avg_f32", torch.bfloat16: "prefix_avg_bf16"}
ROWS_PER_BLOCK = 8         # prefix models (walks x M) a block writes
STEP_BYTES = 16            # csrc/prefix_avg.cu::Step, one per walk position
SMEM_BYTES = 48 * 1024     # the static shared-memory limit


def walks_per_block(m: int) -> int:
    """Walks a block stages and writes: about ROWS_PER_BLOCK prefix models,
    at least one walk.  Short blocks keep the last wave short: at the main
    path's M = 5 a block takes one walk."""
    return max(1, ROWS_PER_BLOCK // max(m, 1))


def launch_plan(leaves: Sequence[tuple[int, int, int]], itemsize: int
                ) -> list[tuple[list[LeafPlan], int]]:
    """Per launch of up to MAX_LEAVES (D, stack pointer, output pointer)
    leaves, weighted_avg's plan: each leaf's vector width (a 16-byte word
    per thread where D is a multiple of the word and its stack and output
    start on 16-byte boundaries, else one column per thread) and its first
    column block in the launch's grid.x, and the launch's column blocks."""
    return [word_plan(leaves[i:i + MAX_LEAVES], itemsize)
            for i in range(0, len(leaves), MAX_LEAVES)]


def prefix_avg_cuda(stacks: Sequence[torch.Tensor], perms: torch.Tensor,
                    n_k: torch.Tensor, *, checked: bool = False
                    ) -> list[torch.Tensor]:
    """Build the prefix models of every (M, ...) stack along the (R, M)
    walks, in one launch per MAX_LEAVES stacks on PyTorch's current
    stream.  Raises ValueError, before launching, on perms outside
    [0, M): the kernel gathers rows by them.  `checked=True` takes perms
    already checked where they were made and reads nothing back."""
    r, m = perms.shape
    if perms.dtype != torch.int64:
        raise ValueError(f"perms must be int64, got {perms.dtype}")
    if n_k.dtype != torch.float32 or tuple(n_k.shape) != (m,):
        raise ValueError(f"n_k must be float32 of shape ({m},), got "
                         f"{n_k.dtype} {tuple(n_k.shape)}")
    if m * STEP_BYTES > SMEM_BYTES:
        raise ValueError(f"prefix_avg takes at most "
                         f"{SMEM_BYTES // STEP_BYTES} clients, got {m}")
    dtype = stacks[0].dtype if stacks else torch.float32
    if dtype not in _ENTRY:
        raise TypeError(f"prefix_avg takes float32 or bfloat16, got {dtype}")
    for s in stacks:
        if s.dtype != dtype or s.dim() == 0 or s.shape[0] != m:
            raise ValueError(f"each stack must be {dtype} with M = {m} rows, "
                             f"the perms' columns; got {s.dtype} "
                             f"{tuple(s.shape)}")
    dev = perms.get_device()
    for name, t in (("perms", perms), ("n_k", n_k),
                    *(("stack", s) for s in stacks)):
        if not t.is_cuda or t.get_device() != dev:
            raise ValueError(f"{name} is on {t.device}, not on "
                             f"{perms.device} (a CUDA device)")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    walks = walks_per_block(m)
    if -(-r // walks) > 65535:
        raise ValueError(f"prefix_avg takes at most {65535 * walks} walks at "
                         f"M = {m}, got {r}")
    # the bounds come back in one read, once the launch is prepared, so
    # that the host's preparation overlaps the card's earlier work
    bounds = (torch.stack(torch.aminmax(perms))
              if perms.numel() and not checked else None)
    outs = [torch.empty((r * m,) + s.shape[1:], dtype=dtype, device=s.device)
            for s in stacks]
    work = [(s, o) for s, o in zip(stacks, outs) if o.numel()]
    calls = c_args(work, perms, n_k)
    entry = getattr(library(), _ENTRY[dtype])
    if bounds is not None:
        lo, hi = bounds.tolist()
        if lo < 0 or hi >= m:
            raise ValueError(f"perms must index [0, {m}), got [{lo}, {hi}]")
    for args in calls:
        check_launch(entry(*args), "prefix_avg")
        LAUNCHES["prefix_avg"] += 1
    return outs


def c_args(work: Sequence[tuple[torch.Tensor, torch.Tensor]],
           perms: torch.Tensor, n_k: torch.Tensor) -> list[tuple]:
    """The C entry's arguments for (stack, output) pairs, one tuple per
    launch."""
    if not work:
        return []
    r, m = perms.shape
    leaves = [(prod(s.shape[1:]), s.data_ptr(), o.data_ptr())
              for s, o in work]
    calls = []
    for i, (plans, blocks_x) in enumerate(launch_plan(
            leaves, work[0][0].element_size())):
        fields = []
        for (d, src, out), p in zip(leaves[i * MAX_LEAVES:], plans):
            fields += (src, out, d, p.blk0, p.vec)
        calls.append((host_table(fields), len(plans), perms.data_ptr(),
                      n_k.data_ptr(), r, m, walks_per_block(m), blocks_x,
                      perms.get_device(), stream_ptr(perms)))
    return calls
