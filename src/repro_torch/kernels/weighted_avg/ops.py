"""Public wrapper: tree-aware batched subset averaging (counterpart of
`repro/kernels/weighted_avg/ops.py`).

`weighted_avg(stacked_tree, weights)` views each stacked leaf as an
(M, D_leaf) matrix and builds the R weighted averages stacked on a leading
axis.  The weights are cast to the leaf's dtype first, as the reference
does.  The CUDA leaves of one device and dtype go to the CUDA kernel
together, in one launch whatever their widths (the reference's D < 2048
cut-over exists only for its 2048-lane tile); a CPU leaf goes to the plain
version; a meta leaf gets an empty output.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.kernels import counted, use_kernel
from repro_torch.kernels.weighted_avg.kernel import weighted_avg_cuda
from repro_torch.kernels.weighted_avg.ref import weighted_avg_ref
from repro_torch.tree import tree_leaves, tree_unflatten

Tree = Any


def weighted_avg(stacked_tree: Tree, weights: torch.Tensor) -> Tree:
    """stacked_tree leaves (M, *s); weights (R, M) -> leaves (R, *s)."""
    leaves = tree_leaves(stacked_tree)
    r, m = weights.shape
    with counted("weighted_avg", r=r, m=m,
                 d=sum(x.numel() for x in leaves) // max(m, 1),
                 itemsize=leaves[0].element_size() if leaves else 4):
        outs: list = [None] * len(leaves)
        groups: dict = {}
        for i, leaf in enumerate(leaves):
            if use_kernel(leaf):
                groups.setdefault((leaf.device, leaf.dtype), []).append(i)
            else:
                flat = weighted_avg_ref(
                    leaf.reshape(leaf.shape[0], -1),
                    weights.to(device=leaf.device, dtype=leaf.dtype))
                outs[i] = flat.reshape((flat.shape[0],) + leaf.shape[1:])
        for (device, dtype), idx in groups.items():
            if device.type == "meta":
                for i in idx:
                    outs[i] = leaves[i].new_empty((r,) + leaves[i].shape[1:])
                continue
            for i, out in zip(idx, weighted_avg_cuda(
                    [leaves[i].contiguous() for i in idx],
                    weights.to(device=device, dtype=dtype).contiguous())):
                outs[i] = out
    return tree_unflatten(stacked_tree, outs)
