"""Public wrapper: tree-aware batched subset averaging (counterpart of
`repro/kernels/weighted_avg/ops.py`).

`weighted_avg(stacked_tree, weights)` views each stacked leaf as an
(M, D_leaf) matrix and builds the R weighted averages stacked on a leading
axis.  The weights are cast to the leaf's dtype first, as the reference
does.  A CUDA leaf goes to the CUDA kernel whatever its width (the
reference's D < 2048 cut-over exists only for its 2048-lane tile); a CPU
leaf goes to the plain version.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.kernels import use_kernel
from repro_torch.kernels.weighted_avg.kernel import weighted_avg_cuda
from repro_torch.kernels.weighted_avg.ref import weighted_avg_ref
from repro_torch.tree import tree_map

Tree = Any


def weighted_avg(stacked_tree: Tree, weights: torch.Tensor) -> Tree:
    """stacked_tree leaves (M, *s); weights (R, M) -> leaves (R, *s)."""
    r = weights.shape[0]

    def one(leaf: torch.Tensor) -> torch.Tensor:
        flat = leaf.reshape(leaf.shape[0], -1)
        w = weights.to(device=leaf.device, dtype=leaf.dtype)
        if use_kernel(leaf):
            out = weighted_avg_cuda(flat.contiguous(), w.contiguous())
        else:
            out = weighted_avg_ref(flat, w)
        return out.reshape((r,) + leaf.shape[1:])

    return tree_map(one, stacked_tree)
