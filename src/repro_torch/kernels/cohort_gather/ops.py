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
`error`, into a word of its own that it reads back at once.

With `axis_name` (a client process group, a run mesh, or the mesh's axis
name `"clients"`) every leaf is this rank's block of a client-sharded
(N_pad, ...) stack, rows [lo, lo + n_local) with lo = its index in the
group times n_local, and `ids` are the global cohort (every rank passes
the same).  One launch of the sharded entry writes the block's hits of
every leaf into one packed buffer, zeros for the other rows (the plain
version on the CPU), one `all_reduce` sums the buffers over the group as
int32 words, and the leaves are views of the sum: bitwise the dense
gather (the reference's bitcast-psum, one collective for the tree instead
of one a leaf).  Ids are checked against `n_clients`, the global N
(default: the blocks' rows times the group's size).
"""
from __future__ import annotations

import math
from typing import Any, Optional

import torch

from repro_torch.kernels import counted, use_kernel
from repro_torch.kernels.cohort_gather.kernel import (
    cohort_gather_cuda, cohort_gather_shard_cuda, shard_layout,
)
from repro_torch.kernels.cohort_gather.ref import (
    cohort_gather_ref, cohort_gather_shard_ref,
)
from repro_torch.tree import tree_leaves, tree_unflatten

Tree = Any


def cohort_gather(tree: Tree, ids, *, axis_name=None,
                  error: Optional[torch.Tensor] = None,
                  n_clients: Optional[int] = None) -> Tree:
    """Every (N, ...) leaf gathered to (M, ...) at rows `ids`, bitwise; with
    `axis_name`, every leaf a block of a client-sharded stack."""
    if axis_name is not None:
        return _cross_shard_gather(tree, ids, axis_name, error, n_clients)
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


def _cross_shard_gather(tree: Tree, ids, axis, error, n_clients) -> Tree:
    """The client-sharded gather: one launch (or the plain version), one
    all_reduce of int32 words over the client group."""
    from repro_torch.launch.mesh import (
        all_reduce_words, client_group, group_rank,
    )
    leaves = tree_leaves(tree)
    n_local = leaves[0].shape[0]
    if any(x.dim() == 0 or x.shape[0] != n_local for x in leaves):
        raise ValueError("a sharded gather's leaves must be blocks of the "
                         "same client rows")
    m = len(ids)
    row_bytes = [math.prod(x.shape[1:]) * x.element_size() for x in leaves]
    device = leaves[0].device
    with counted("cohort_gather_shard", m=m, row_bytes=sum(row_bytes)):
        if device.type == "meta":     # the kernel's shapes; no collective
            return tree_unflatten(tree, [x.new_empty((m,) + x.shape[1:])
                                         for x in leaves])
        group = client_group(axis)
        index, size = group_rank(group)
        lo, n_total = index * n_local, n_clients or n_local * size
        if use_kernel(leaves[0]):
            words = cohort_gather_shard_cuda(
                [x.contiguous() for x in leaves], ids, lo, n_total, error)
        else:
            words = cohort_gather_shard_ref(
                leaves, torch.as_tensor(ids).to(device), lo, n_total)
        all_reduce_words(words, group)
        flat = words.view(torch.uint8)
        offsets, _ = shard_layout(row_bytes, m)
        outs = [flat[off:off + m * rb].view(x.dtype).reshape(
                    (m,) + x.shape[1:])
                for x, off, rb in zip(leaves, offsets, row_bytes)]
    return tree_unflatten(tree, outs)


def cohort_take(arr: torch.Tensor, ids, *, axis_name=None) -> torch.Tensor:
    """Gather rows `ids` (M,) from `arr` (N, ...) -> (M, ...), bitwise."""
    return cohort_gather(arr, ids, axis_name=axis_name)
