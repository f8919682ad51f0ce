"""Public wrapper: tree-aware cohort gather (counterpart of
`repro/kernels/cohort_gather/ops.py`, its dense path).

`cohort_gather(tree, ids)` views every (N, ...) leaf as an (N, D) matrix
and gathers the M rows `ids`; `cohort_take(arr, ids)` is its one-leaf
form.  The CUDA leaves of one device go to the CUDA kernel together, in
one launch whatever their widths (the reference's D < 2048 cut-over to its
ref exists only for its 2048-lane tile); a CPU leaf goes to the plain
version; a meta leaf gets an empty output.  On the card, host ids (a list,
a numpy array or a CPU tensor)
are checked on the host and passed to the kernel by value; CUDA ids go to
the device-id entry, which reads them from the card and writes an id out
of range into the int64 word `error` (`kernel.error_word`; the caller
reads it with `kernel.raise_on_error` after its run), or, without
`error`, into a word of its own that it reads back at once.  The
reference's cross-shard path (`axis_name`, a bitcast-psum over a client
mesh axis) comes with the client-sharding slice of the port.
"""
from __future__ import annotations

import math
from typing import Any, Optional

import torch

from repro_torch.kernels import counted, use_kernel
from repro_torch.kernels.cohort_gather.kernel import cohort_gather_cuda
from repro_torch.kernels.cohort_gather.ref import cohort_gather_ref
from repro_torch.tree import tree_leaves, tree_unflatten

Tree = Any


def cohort_gather(tree: Tree, ids, *, axis_name: Optional[str] = None,
                  error: Optional[torch.Tensor] = None) -> Tree:
    """Every (N, ...) leaf gathered to (M, ...) at rows `ids`, bitwise."""
    if axis_name is not None:
        raise NotImplementedError(
            "cohort_take(axis_name=...) is not ported yet: the cross-shard "
            "gather comes with the client-sharding slice of the PyTorch port "
            "(see ROADMAP.md)")
    leaves = tree_leaves(tree)
    device_ids = isinstance(ids, torch.Tensor) and ids.device.type != "cpu"
    with counted("cohort_gather", m=len(ids), device_ids=device_ids,
                 row_bytes=sum(math.prod(x.shape[1:]) * x.element_size()
                               for x in leaves)):
        outs: list = [None] * len(leaves)
        groups: dict = {}
        for i, leaf in enumerate(leaves):
            if use_kernel(leaf):
                groups.setdefault(leaf.device, []).append(i)
            else:
                flat = cohort_gather_ref(leaf.reshape(leaf.shape[0], -1),
                                         torch.as_tensor(ids).to(leaf.device))
                outs[i] = flat.reshape((flat.shape[0],) + leaf.shape[1:])
        for device, idx in groups.items():
            if device.type == "meta":
                for i in idx:
                    outs[i] = leaves[i].new_empty((len(ids),)
                                                  + leaves[i].shape[1:])
                continue
            for i, out in zip(idx, cohort_gather_cuda(
                    [leaves[i].contiguous() for i in idx], ids, error)):
                outs[i] = out
    return tree_unflatten(tree, outs)


def cohort_take(arr: torch.Tensor, ids, *,
                axis_name: Optional[str] = None) -> torch.Tensor:
    """Gather rows `ids` (M,) from `arr` (N, ...) -> (M, ...), bitwise."""
    return cohort_gather(arr, ids, axis_name=axis_name)
