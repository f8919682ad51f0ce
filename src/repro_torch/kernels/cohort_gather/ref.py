"""Plain PyTorch version of the cohort_gather kernel (counterpart of
`repro/kernels/cohort_gather/ref.py`).

A gather copies bits, so the kernel and this version are bitwise equal by
construction; an id outside [0, N) raises here as it does on the card.
"""
from __future__ import annotations

import torch


def cohort_gather_ref(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """table (N, D) x ids (M,) on the table's device (host or card) ->
    (M, D): `out[i] = table[ids[i]]`."""
    return torch.index_select(table, 0, ids.to(torch.int64))
