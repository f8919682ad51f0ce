"""Launcher of the hand-written CUDA cohort_gather kernel
(`kernels/csrc/cohort_gather.cu`; counterpart of
`repro/kernels/cohort_gather/kernel.py`).

A list of contiguous tables (N_i, ...) of any dtype x M cohort ids -> a
list of (M, ...): a raw copy of the selected rows.  One launch covers up
to MAX_LEAVES tables, with a table of leaves passed by value
(`launch_plan`).  Host ids are checked on the host (`checked_ids`) and go
to the kernel by value too, so the call allocates no flag, launches no
memset and does not wait for the card; the card's time is a few
microseconds, so the host's time per call bounds a round's gather.

CUDA ids go to the device-id entry (`cohort_gather_ids`), which reads them
from the card's memory: the form a captured round needs, whose cohort is
chosen on the card.  An id outside a table's rows is written into an
int64 error word on the card (`error_word`) and its row is not copied;
`raise_on_error` reads the word and raises IndexError.  A caller that
passes its own word (a captured run) reads it once, after the run; a call
without one makes its own word and reads it back at once.

The sharded entry (`cohort_gather_shard_cuda`) takes one rank's block of
client rows [lo, lo + n_local) of every table, the M global cohort ids on
the card and the global N, and writes every leaf's M rows into one packed
int32 buffer (`shard_layout`: the leaves in order, each segment padded to
16 bytes): the rows the block holds, zeros for the others.  Summed over
the client group as int32 words (`ops.py`), the blocks' buffers give the
dense gather bit for bit (the argument is in `csrc/cohort_gather.cu`).
"""
from __future__ import annotations

from math import prod
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.kernels import (
    LAUNCHES, check_launch, host_table, library, stream_ptr,
)

THREADS = 256          # csrc/cohort_gather.cu::kThreads
UNROLL = 4             # words in flight per thread (kUnroll)
MAX_LEAVES = 16        # csrc/cohort_gather.cu::kMaxLeaves
MAX_IDS = 256          # csrc/cohort_gather.cu::kMaxIds: ids passed by value
MAX_DEVICE_IDS = 65535  # device ids: one grid.y slot each
SEGMENT_ALIGN = 16     # the sharded entry pads each leaf's segment to this


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


def error_word(device) -> torch.Tensor:
    """A zeroed (1,) int64 error word for the device-id entry."""
    return torch.zeros((1,), dtype=torch.int64, device=device)


def raise_on_error(error: torch.Tensor, n: int) -> None:
    """Read an error word back (a sync) and raise IndexError if a gather
    met an id outside [0, n)."""
    bad = int(error.reshape(()).item())
    if bad:
        raise IndexError(f"cohort ids must index [0, {n}), got {bad}")


def _device_ids(ids: torch.Tensor, device) -> torch.Tensor:
    if ids.dim() != 1 or ids.dtype.is_floating_point or ids.dtype.is_complex \
            or ids.dtype == torch.bool:
        raise ValueError(f"ids must be a 1-D tensor of integers, got "
                         f"{ids.dtype} of shape {tuple(ids.shape)}")
    if ids.device != device:
        raise ValueError(f"ids are on {ids.device}, the tables on {device}")
    if len(ids) > MAX_DEVICE_IDS:
        raise ValueError(f"the cohort_gather kernel takes at most "
                         f"{MAX_DEVICE_IDS} device ids, got {len(ids)}")
    return ids.to(torch.int64).contiguous()


def cohort_gather_cuda(tables: Sequence[torch.Tensor], ids,
                       error: Optional[torch.Tensor] = None
                       ) -> list[torch.Tensor]:
    """Gather rows `ids` of every (N_i, ...) table, in one launch per
    MAX_LEAVES tables on PyTorch's current stream.  CUDA ids go to the
    device-id entry, which writes an id out of range into `error` (made and
    read back here when None); other ids are checked on the host."""
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
    n = min(t.shape[0] for t in tables)
    on_card = isinstance(ids, torch.Tensor) and ids.is_cuda
    if on_card:
        ids = _device_ids(ids, tables[0].device)
        m = len(ids)
    else:
        host = checked_ids(ids, n)
        m = len(host)
    outs = [torch.empty((m,) + t.shape[1:], dtype=t.dtype,
                        device=t.device) for t in tables]
    work = [(t, o) for t, o in zip(tables, outs) if o.numel()]
    if not on_card:
        for i in range(0, len(work), MAX_LEAVES):
            rc = library().cohort_gather(*c_args(work[i:i + MAX_LEAVES],
                                                 host))
            check_launch(rc, "cohort_gather")
            LAUNCHES["cohort_gather"] += 1
        return outs
    word = error_word(tables[0].device) if error is None else error
    if error is not None and (error.dtype != torch.int64 or error.numel() != 1
                              or error.device != tables[0].device):
        raise ValueError("error must be one int64 on the tables' device")
    for i in range(0, len(work), MAX_LEAVES):
        rc = library().cohort_gather_ids(*device_c_args(
            work[i:i + MAX_LEAVES], ids, word))
        check_launch(rc, "cohort_gather")
        LAUNCHES["cohort_gather"] += 1
    if error is None:
        raise_on_error(word, n)
    return outs


def _leaf_table(work: Sequence[tuple[torch.Tensor, torch.Tensor]]
                ) -> tuple:
    """(leaf table, leaves, blocks) for (table, output) pairs."""
    leaves = [(prod(t.shape[1:]) * t.element_size(), t.data_ptr(),
               o.data_ptr()) for t, o in work]
    plans, blocks_x = launch_plan(leaves)
    fields = []
    for (row_bytes, src, dst), p, (t, _) in zip(leaves, plans, work):
        fields += (src, dst, row_bytes, t.shape[0], p.blk0, p.unit)
    return host_table(fields), len(work), blocks_x


def c_args(work: Sequence[tuple[torch.Tensor, torch.Tensor]],
           host_ids: list[int]) -> tuple:
    """The C entry's arguments for (table, output) pairs and checked host
    ids."""
    table, n, blocks_x = _leaf_table(work)
    t0 = work[0][0]
    return (table, n, host_table(host_ids), len(host_ids), blocks_x,
            t0.get_device(), stream_ptr(t0))


def device_c_args(work: Sequence[tuple[torch.Tensor, torch.Tensor]],
                  ids: torch.Tensor, error: torch.Tensor) -> tuple:
    """The device-id C entry's arguments for (table, output) pairs, (M,)
    int64 CUDA ids and the error word."""
    table, n, blocks_x = _leaf_table(work)
    t0 = work[0][0]
    return (table, n, ids.data_ptr(), len(ids), blocks_x, error.data_ptr(),
            t0.get_device(), stream_ptr(t0))


def shard_layout(row_bytes: Sequence[int], m: int) -> tuple[list[int], int]:
    """The packed buffer of the sharded entry: each leaf's byte offset (its
    M rows of `row_bytes`, then zeros up to SEGMENT_ALIGN bytes) and the
    buffer's total bytes, a whole number of int32 words."""
    offsets, off = [], 0
    for rb in row_bytes:
        offsets.append(off)
        off += -(-m * rb // SEGMENT_ALIGN) * SEGMENT_ALIGN
    return offsets, off


def cohort_gather_shard_cuda(tables: Sequence[torch.Tensor], ids, lo: int,
                             n_total: int,
                             error: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """The packed (words,) int32 buffer of one rank's block: each table's
    rows at `ids` (global, a CUDA tensor or host ids) that lie in [lo, lo +
    n_local), zeros for the others, in `shard_layout`, one launch per
    MAX_LEAVES tables on PyTorch's current stream.  An id outside [0,
    n_total) is written into `error` (made and read back here when None)."""
    if not tables:
        raise ValueError("the sharded gather needs at least one table")
    dev = tables[0].device
    for t in tables:
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"a table is on {t.device}, not on {dev} (a "
                             "CUDA device)")
        if t.dim() == 0 or not t.is_contiguous() \
                or t.shape[0] != tables[0].shape[0]:
            raise ValueError(f"tables must be contiguous blocks of the same "
                             f"rows, got shape {tuple(t.shape)}")
    if lo < 0 or n_total < 1:
        raise ValueError(f"a block from row {lo} of {n_total} clients")
    if not isinstance(ids, torch.Tensor):
        ids = torch.as_tensor(np.asarray(ids, np.int64), device=dev)
    ids = _device_ids(ids.to(dev) if not ids.is_cuda else ids, dev)
    m = len(ids)
    row_bytes = [prod(t.shape[1:]) * t.element_size() for t in tables]
    offsets, total = shard_layout(row_bytes, m)
    words = torch.empty((total // 4,), dtype=torch.int32, device=dev)
    flat = words.view(torch.uint8)
    work = [(t, flat[off:off + m * rb])
            for t, off, rb in zip(tables, offsets, row_bytes) if m * rb]
    word = error_word(dev) if error is None else error
    if error is not None and (error.dtype != torch.int64 or error.numel() != 1
                              or error.device != dev):
        raise ValueError("error must be one int64 on the tables' device")
    for i in range(0, len(work), MAX_LEAVES):
        rc = library().cohort_gather_shard(*shard_c_args(
            work[i:i + MAX_LEAVES], ids, lo, n_total, word))
        check_launch(rc, "cohort_gather_shard")
        LAUNCHES["cohort_gather_shard"] += 1
    if error is None:
        raise_on_error(word, n_total)
    return words


def shard_c_args(work: Sequence[tuple[torch.Tensor, torch.Tensor]],
                 ids: torch.Tensor, lo: int, n_total: int,
                 error: torch.Tensor) -> tuple:
    """The sharded C entry's arguments for (block table, output segment)
    pairs, (M,) int64 CUDA ids, the block's first row, N and the error
    word."""
    table, n, blocks_x = _leaf_table(work)
    t0 = work[0][0]
    return (table, n, ids.data_ptr(), len(ids), blocks_x, lo, n_total,
            error.data_ptr(), t0.get_device(), stream_ptr(t0))
