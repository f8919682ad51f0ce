"""Plain PyTorch version of the cohort_gather kernel (counterpart of
`repro/kernels/cohort_gather/ref.py`).

A gather copies bits, so the kernel and this version are bitwise equal by
construction; an id outside [0, N) raises here as it does on the card.
`cohort_gather_shard_ref` is the sharded entry's: one block's masked
gather into the packed int32 buffer of `kernel.shard_layout`.
"""
from __future__ import annotations

from math import prod
from typing import Sequence

import torch


def cohort_gather_ref(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """table (N, D) x ids (M,) on the table's device (host or card) ->
    (M, D): `out[i] = table[ids[i]]`."""
    return torch.index_select(table, 0, ids.to(torch.int64))


def cohort_gather_shard_ref(tables: Sequence[torch.Tensor],
                            ids: torch.Tensor, lo: int,
                            n_total: int) -> torch.Tensor:
    """Block tables (n_local, ...) of global rows [lo, lo + n_local) x
    global ids (M,) -> the packed (words,) int32 buffer: each table's M
    rows where the block holds the id, zeros elsewhere, every segment
    padded with zeros to 16 bytes.  An id outside [0, n_total) raises
    IndexError."""
    from repro_torch.kernels.cohort_gather.kernel import shard_layout
    ids = ids.to(torch.int64)
    m = ids.shape[0]
    if m and (int(ids.min()) < 0 or int(ids.max()) >= n_total):
        raise IndexError(f"cohort ids must index [0, {n_total}), got "
                         f"{ids.tolist()}")
    row_bytes = [prod(t.shape[1:]) * t.element_size() for t in tables]
    offsets, total = shard_layout(row_bytes, m)
    out = torch.zeros((total,), dtype=torch.uint8, device=ids.device)
    for t, rb, off in zip(tables, row_bytes, offsets):
        n_local = t.shape[0]
        loc = ids - lo
        hit = (loc >= 0) & (loc < n_local)
        rows = t.contiguous().reshape(n_local, -1).view(torch.uint8)
        got = torch.index_select(rows, 0, torch.clamp(loc, 0, n_local - 1))
        got = torch.where(hit[:, None], got, torch.zeros_like(got))
        out[off:off + m * rb] = got.reshape(-1)
    return out.view(torch.int32)
