"""Launcher of the hand-written CUDA delta_codec kernel
(`kernels/csrc/delta_codec.cu`; counterpart of
`repro/kernels/delta_codec/kernel.py`).

Stacks (M, ...) float32, each with its reference row (...) or None ->
stacks of the same shapes: every row w becomes `ref + rt(w - ref)`, or
`rt(w)` without a reference, where `rt` roundtrips a row through `codec`
with the leaf's keep count `k`.  One launch covers up to MAX_LEAVES leaves:
the wrapper passes the kernel a table of leaves by value (`leaf_tables`),
and each (leaf, row) pair is one cluster of CLUSTER blocks, each block
owning a slice of the row.  The kernel masks ragged edges itself, so there
is no padding and no `d_true`.
"""
from __future__ import annotations

import ctypes
from math import prod
from typing import NamedTuple, Optional, Sequence

import torch

from repro_torch.kernels import (
    LAUNCHES, check_launch, host_table, library, stream_ptr,
)
from repro_torch.kernels.delta_codec.ref import CODEC_IDS

CLUSTER = 8                  # csrc/delta_codec.cu::kCluster
MAX_LEAVES = 32              # csrc/delta_codec.cu::kMaxLeaves
MAX_STAGE_BYTES = 220 * 1024  # csrc/delta_codec.cu::kMaxStageBytes
MAX_D = 2 ** 31 - 1          # the kernel counts a row's keys in 32 bits
WORD_BYTES = 16


class LeafPlan(NamedTuple):
    slice: int     # columns of a row per block of the cluster, a multiple of 4
    vec: int       # 4: 16-byte words; 1: 4-byte words
    staged: bool   # the slice is kept in shared memory; else re-read per pass


def leaf_slice(d: int) -> int:
    """Columns per block: d over CLUSTER blocks, rounded up to 16 bytes."""
    per = -(-d // CLUSTER)
    return -(-per // 4) * 4


def launch_plan(leaves: Sequence[tuple[int, int, int, int]]
                ) -> tuple[list[LeafPlan], int]:
    """Per (d, stack pointer, reference pointer or 0, output pointer) leaf:
    its slice, its word (16 bytes where d is a multiple of 4 and every
    pointer is 16-byte aligned, else 4) and whether its slice fits in
    shared memory; and the launch's dynamic shared memory a block, sized
    for the widest slice that fits."""
    plans = []
    for d, *ptrs in leaves:
        cols = leaf_slice(d)
        wide = d % 4 == 0 and all(p % WORD_BYTES == 0 for p in ptrs)
        plans.append(LeafPlan(cols, 4 if wide else 1,
                              4 * cols <= MAX_STAGE_BYTES))
    smem = max((4 * p.slice for p in plans if p.staged), default=0)
    return plans, smem


Work = tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor, int]


def leaf_tables(work: Sequence[Work]) -> list[tuple[list[int], int, int]]:
    """(stack, reference or None, output, k) leaves -> one (flat table, leaf
    count, dynamic shared memory) per launch of at most MAX_LEAVES leaves."""
    tables = []
    for i in range(0, len(work), MAX_LEAVES):
        group = work[i:i + MAX_LEAVES]
        leaves = [(s.numel() // s.shape[0], s.data_ptr(),
                   0 if r is None else r.data_ptr(), o.data_ptr())
                  for s, r, o, _ in group]
        plans, smem = launch_plan(leaves)
        fields = []
        for (d, src, ref, out), (*_, k), p in zip(leaves, group, plans):
            fields += (src, ref, out, d, k, p.slice, p.vec)
        tables.append((fields, len(group), smem))
    return tables


def _check(stacks: Sequence[torch.Tensor],
           refs: Sequence[Optional[torch.Tensor]], codec: str,
           ks: Sequence[int]) -> None:
    if codec not in CODEC_IDS:
        raise ValueError(f"unknown delta codec {codec!r}")
    if not stacks:
        return
    m = stacks[0].shape[0] if stacks[0].dim() else None
    for s, r, k in zip(stacks, refs, ks, strict=True):
        for name, t in (("stack", s), ("reference", r)):
            if t is None:
                continue
            if t.dtype != torch.float32:
                raise TypeError(f"delta_codec takes float32, got a {name} "
                                f"of {t.dtype}")
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
        if s.dim() == 0 or s.shape[0] != m:
            raise ValueError(f"every stack must have the same M = {m} rows, "
                             f"got {tuple(s.shape)}")
        d = s.numel() // m if m else prod(s.shape[1:])
        if r is not None and r.numel() != d:
            raise ValueError(f"reference of {r.numel()} entries for rows of "
                             f"{d}")
        if d > MAX_D:
            raise ValueError(f"delta_codec takes rows of at most {MAX_D} "
                             f"entries, got {d}")
        if codec != "quant8" and s.numel() and not 1 <= k <= d:
            raise ValueError(f"k must be in [1, {d}], got {k}")
    dev = stacks[0].get_device()       # -1 on the CPU
    for t in (*stacks, *refs):
        if t is not None and (dev < 0 or t.get_device() != dev):
            raise ValueError(f"the stacks and references must lie on one "
                             f"CUDA device, got one on {t.device}")


def delta_codec_leaves_cuda(stacks: Sequence[torch.Tensor],
                            refs: Sequence[Optional[torch.Tensor]],
                            codec: str, ks: Sequence[int]
                            ) -> list[torch.Tensor]:
    """Roundtrip every row of every (M, ...) stack through `codec`, as a
    delta from the leaf's reference row where it has one, in one launch per
    MAX_LEAVES leaves on PyTorch's current stream."""
    _check(stacks, refs, codec, ks)
    outs = [torch.empty_like(s) for s in stacks]
    work = [(s, r, o, k) for s, r, o, k in zip(stacks, refs, outs, ks)
            if o.numel()]
    if work:
        first = work[0][0]
        for fields, n, smem in leaf_tables(work):
            rc = library().delta_codec_f32(
                host_table(fields), n, first.shape[0], CODEC_IDS[codec],
                smem, first.get_device(), stream_ptr(first))
            check_launch(rc, "delta_codec")
            LAUNCHES["delta_codec"] += 1
    return outs


def delta_codec_cuda(x: torch.Tensor, codec: str, k: int = 0) -> torch.Tensor:
    """Roundtrip each row of a (rows, d) matrix, in one launch."""
    if codec not in CODEC_IDS:
        raise ValueError(f"unknown delta codec {codec!r}")
    if x.dtype != torch.float32 or x.dim() != 2:
        raise TypeError(f"delta_codec takes a 2-D float32 matrix, got "
                        f"{x.dtype} {tuple(x.shape)}")
    return delta_codec_leaves_cuda([x], [None], codec, [k])[0]


def occupancy(smem: int, device: int) -> int:
    """Clusters of the kernel the card holds at once with `smem` bytes of
    dynamic shared memory a block."""
    clusters = ctypes.c_int64(0)
    check_launch(library().delta_codec_occupancy(
        smem, device, ctypes.byref(clusters)), "delta_codec occupancy")
    return clusters.value
