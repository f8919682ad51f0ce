"""Public wrapper: tree-aware streaming prefix averaging (counterpart of
`repro/kernels/prefix_avg/ops.py`).

`prefix_avg(stacked_tree, perms, n_k)` views each stacked leaf as an
(M, D_leaf) matrix and builds the R*M prefix-averaged models stacked on a
leading walk-major axis, the order the batched utility consumes.  A CUDA
leaf goes to the CUDA kernel, whatever its width (the kernel masks the
ragged edge, so the reference's D < 2048 cut-over to its ref has no
counterpart on the card); a CPU leaf goes to the plain version.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.kernels import use_kernel
from repro_torch.kernels.prefix_avg.kernel import prefix_avg_cuda
from repro_torch.kernels.prefix_avg.ref import prefix_avg_ref, walk_weights
from repro_torch.tree import tree_leaves, tree_map

Tree = Any


def prefix_avg(stacked_tree: Tree, perms: torch.Tensor,
               n_k: torch.Tensor) -> Tree:
    """stacked_tree leaves (M, *s); perms (R, M) -> leaves (R*M, *s)."""
    r, m = perms.shape
    if not use_kernel(tree_leaves(stacked_tree)[0]):
        return tree_map(lambda leaf: prefix_avg_ref(
            leaf.reshape(m, -1), perms, n_k).reshape((r * m,) + leaf.shape[1:]),
            stacked_tree)
    lo, hi = torch.aminmax(perms)
    if perms.numel() and (int(lo) < 0 or int(hi) >= m):
        raise ValueError(f"perms must index [0, {m}), got [{int(lo)}, "
                         f"{int(hi)}]")
    perms = perms.to(torch.int64).contiguous()
    scale, ncum = walk_weights(perms, n_k)

    def one(leaf):
        out = prefix_avg_cuda(leaf.reshape(m, -1).contiguous(), perms,
                              scale, ncum)
        return out.reshape((r * m,) + leaf.shape[1:])

    return tree_map(one, stacked_tree)
