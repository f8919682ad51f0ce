"""Launcher of the hand-written CUDA cohort_gather kernel
(`kernels/csrc/cohort_gather.cu`; counterpart of
`repro/kernels/cohort_gather/kernel.py`).

A list of contiguous tables (N_i, ...) of any dtype x M cohort ids -> a
list of (M, ...): a raw copy of the selected rows.  One launch covers up
to MAX_LEAVES tables.  The ids are checked on the host (`checked_ids`) and
go to the kernel by value with a table of leaves (`launch_plan`), so the
call allocates no flag, launches no memset and does not wait for the card.
The card's time is a few microseconds, so the host's time per call bounds
a round's gather: the launcher keeps to host ints and one array of them.
"""
from __future__ import annotations

from math import prod
from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.kernels import (
    LAUNCHES, check_launch, host_table, library, stream_ptr,
)

THREADS = 256          # csrc/cohort_gather.cu::kThreads
UNROLL = 4             # words in flight per thread (kUnroll)
MAX_LEAVES = 16        # csrc/cohort_gather.cu::kMaxLeaves
MAX_IDS = 256          # csrc/cohort_gather.cu::kMaxIds: ids passed by value


class LeafPlan(NamedTuple):
    unit: int      # bytes per word: 16, 4 or 1
    blk0: int      # first row chunk of the leaf in the launch's grid.x
    blocks: int    # row chunks of the leaf


def checked_ids(ids, n: int) -> list[int]:
    """The cohort ids as host ints, each in [0, n).

    `ids` may be a sequence, a numpy array or a tensor.  A CUDA tensor is
    copied to the host first, which waits for the card: the engines pass
    host ids.  An id outside [0, n) raises IndexError, as `index_select`
    does; ids that are not a 1-D run of integers, or more than MAX_IDS of
    them (they would not fit in the kernel's parameters), raise
    ValueError."""
    if isinstance(ids, torch.Tensor):
        ok = ids.dim() == 1 and not (ids.dtype.is_floating_point
                                     or ids.dtype.is_complex
                                     or ids.dtype == torch.bool)
        shape = tuple(ids.shape)
    else:
        ids = np.asarray(ids)
        ok = ids.ndim == 1 and (ids.size == 0 or ids.dtype.kind in "iu")
        shape = ids.shape
    if not ok:
        raise ValueError(f"ids must be a 1-D sequence of integers, got "
                         f"{ids.dtype} of shape {shape}")
    if len(ids) > MAX_IDS:
        raise ValueError(f"the cohort_gather kernel takes at most {MAX_IDS} "
                         f"ids, got {len(ids)}")
    host = ids.tolist()
    if host and (min(host) < 0 or max(host) >= n):
        raise IndexError(f"cohort ids must index [0, {n}), got {host}")
    return host


def launch_plan(leaves: Sequence[tuple[int, int, int]]
                ) -> tuple[list[LeafPlan], int]:
    """Per (row bytes, table pointer, output pointer) leaf, its word (the
    widest of 16, 4 or 1 bytes on which every row of the table and of the
    output starts) and its run of row chunks (THREADS * UNROLL words
    each), laid one after the other along grid.x; and the total number of
    chunks."""
    plans, blk0 = [], 0
    for row_bytes, src_ptr, dst_ptr in leaves:
        unit = next((u for u in (16, 4) if row_bytes % u == 0
                     and src_ptr % u == 0 and dst_ptr % u == 0), 1)
        blocks = -(-row_bytes // (THREADS * UNROLL * unit))
        plans.append(LeafPlan(unit, blk0, blocks))
        blk0 += blocks
    return plans, blk0


def cohort_gather_cuda(tables: Sequence[torch.Tensor],
                       ids) -> list[torch.Tensor]:
    """Gather rows `ids` of every (N_i, ...) table, in one launch per
    MAX_LEAVES tables on PyTorch's current stream."""
    if not tables:
        return []
    dev = tables[0].get_device()
    for t in tables:
        if not t.is_cuda or t.get_device() != dev:
            raise ValueError(f"a table is on {t.device}, not on "
                             f"{tables[0].device} (a CUDA device)")
        if t.dim() == 0 or not t.is_contiguous():
            raise ValueError(f"tables must be contiguous with a row axis, "
                             f"got shape {tuple(t.shape)}")
    host = checked_ids(ids, min(t.shape[0] for t in tables))
    outs = [torch.empty((len(host),) + t.shape[1:], dtype=t.dtype,
                        device=t.device) for t in tables]
    work = [(t, o) for t, o in zip(tables, outs) if o.numel()]
    for i in range(0, len(work), MAX_LEAVES):
        rc = library().cohort_gather(*c_args(work[i:i + MAX_LEAVES], host))
        check_launch(rc, "cohort_gather")
        LAUNCHES["cohort_gather"] += 1
    return outs


def c_args(work: Sequence[tuple[torch.Tensor, torch.Tensor]],
           host_ids: list[int]) -> tuple:
    """The C entry's arguments for (table, output) pairs and checked host
    ids."""
    leaves = [(prod(t.shape[1:]) * t.element_size(), t.data_ptr(),
               o.data_ptr()) for t, o in work]
    plans, blocks_x = launch_plan(leaves)
    fields = []
    for (row_bytes, src, dst), p, (t, _) in zip(leaves, plans, work):
        fields += (src, dst, row_bytes, t.shape[0], p.blk0, p.unit)
    t0 = work[0][0]
    return (host_table(fields), len(work), host_table(host_ids),
            len(host_ids), blocks_x, t0.get_device(), stream_ptr(t0))
