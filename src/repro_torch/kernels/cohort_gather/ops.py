"""Public wrapper: tree-aware cohort gather (counterpart of
`repro/kernels/cohort_gather/ops.py`, its dense path).

`cohort_take(arr, ids)` views an (N, ...) leaf as an (N, D) matrix and
gathers the M rows `ids`.  A CUDA leaf goes to the CUDA kernel whatever
its width (the reference's D < 2048 cut-over to its ref exists only for
its 2048-lane tile); a CPU leaf goes to the plain version.  The
reference's cross-shard path (`axis_name`, a bitcast-psum over a client
mesh axis) comes with the client-sharding slice of the port.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.kernels import use_kernel
from repro_torch.kernels.cohort_gather.kernel import cohort_gather_cuda
from repro_torch.kernels.cohort_gather.ref import cohort_gather_ref
from repro_torch.tree import tree_map

Tree = Any


def cohort_take(arr: torch.Tensor, ids: torch.Tensor, *,
                axis_name: Optional[str] = None) -> torch.Tensor:
    """Gather rows `ids` (M,) from `arr` (N, ...) -> (M, ...), bitwise."""
    if axis_name is not None:
        raise NotImplementedError(
            "cohort_take(axis_name=...) is not ported yet: the cross-shard "
            "gather comes with the client-sharding slice of the PyTorch port "
            "(see ROADMAP.md)")
    m = ids.shape[0]
    flat = arr.reshape(arr.shape[0], -1)
    if use_kernel(arr):
        out = cohort_gather_cuda(flat.contiguous(),
                                 ids.to(device=arr.device,
                                        dtype=torch.int64).contiguous())
    else:
        out = cohort_gather_ref(flat, ids)
    return out.reshape((m,) + arr.shape[1:])


def cohort_gather(tree: Tree, ids: torch.Tensor, *,
                  axis_name: Optional[str] = None) -> Tree:
    """Tree version: every (N, ...) leaf gathered to (M, ...)."""
    return tree_map(lambda leaf: cohort_take(leaf, ids, axis_name=axis_name),
                    tree)
