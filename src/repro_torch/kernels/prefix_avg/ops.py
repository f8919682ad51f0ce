"""Public wrapper: tree-aware streaming prefix averaging (counterpart of
`repro/kernels/prefix_avg/ops.py`).

`prefix_avg(stacked_tree, perms, n_k)` views each stacked leaf as an
(M, D_leaf) matrix and builds the R*M prefix-averaged models stacked on a
leading walk-major axis, the order the batched utility consumes.  The CUDA
leaves of one device and dtype go to the CUDA kernel together, in one
launch whatever their widths (the kernel masks the ragged edge, so the
reference's D < 2048 cut-over to its ref has no counterpart on the card);
a CPU leaf goes to the plain version; a meta leaf gets an empty output.
The launcher raises ValueError on perms outside [0, M), which reads the
card back; `checked=True` skips that read for walks the caller checked
where it made them.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.kernels import counted, use_kernel
from repro_torch.kernels.prefix_avg.kernel import prefix_avg_cuda
from repro_torch.kernels.prefix_avg.ref import prefix_avg_ref
from repro_torch.tree import tree_leaves, tree_unflatten

Tree = Any


def prefix_avg(stacked_tree: Tree, perms: torch.Tensor,
               n_k: torch.Tensor, *, checked: bool = False) -> Tree:
    """stacked_tree leaves (M, *s); perms (R, M) -> leaves (R*M, *s)."""
    r, m = perms.shape
    leaves = tree_leaves(stacked_tree)
    with counted("prefix_avg", r=r, m=m,
                 d=sum(x.numel() for x in leaves) // max(m, 1),
                 itemsize=leaves[0].element_size() if leaves else 4):
        outs: list = [None] * len(leaves)
        groups: dict = {}
        for i, leaf in enumerate(leaves):
            if use_kernel(leaf):
                groups.setdefault((leaf.device, leaf.dtype), []).append(i)
            else:
                outs[i] = prefix_avg_ref(leaf.reshape(m, -1), perms, n_k
                                         ).reshape((r * m,) + leaf.shape[1:])
        for (device, dtype), idx in groups.items():
            if device.type == "meta":
                for i in idx:
                    outs[i] = leaves[i].new_empty((r * m,)
                                                  + leaves[i].shape[1:])
                continue
            for i, out in zip(idx, prefix_avg_cuda(
                    [leaves[i].contiguous() for i in idx],
                    perms.to(device=device, dtype=torch.int64).contiguous(),
                    n_k.to(device=device, dtype=torch.float32).contiguous(),
                    checked=checked)):
                outs[i] = out
    return tree_unflatten(stacked_tree, outs)
