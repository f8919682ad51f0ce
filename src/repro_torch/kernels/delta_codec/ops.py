"""Public wrapper: the upload-codec roundtrip on a stacked cohort tree
(counterpart of `repro/kernels/delta_codec/ops.py`).

`delta_codec_roundtrip(stacked, params, codec)`: for each leaf, the
(M, *s) client weights minus the (*s,) server weights become an (M, d)
delta matrix, roundtripped rowwise, and added back.  The sparse codecs keep
`leaf_topk_k(d)` entries per row, the per-leaf codecs' rule, so the result
equals `federated.compression`'s per-client roundtrip bitwise.  The CUDA
leaves of one device go to the CUDA kernel together, in one launch whatever
their widths (the reference's 2048 <= d <= 2^18 window exists only for its
VMEM-resident row), with the subtraction and the addition inside it; a CPU
leaf goes to the plain version; a meta leaf gets an empty output.
"""
from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.kernels import counted, use_kernel
from repro_torch.kernels.delta_codec.kernel import delta_codec_leaves_cuda
from repro_torch.kernels.delta_codec.ref import delta_codec_ref
from repro_torch.tree import tree_leaves, tree_unflatten

Tree = Any


def delta_codec_roundtrip(stacked: Tree, params: Tree, codec: str) -> Tree:
    """stacked leaves (M, *s), params leaves (*s,) -> roundtripped stack."""
    # deferred: importing repro_torch.federated runs its server module
    from repro_torch.federated.compression import leaf_topk_k

    if codec == "identity":
        return stacked
    leaves, refs = tree_leaves(stacked), tree_leaves(params)
    ks = [leaf_topk_k(math.prod(leaf.shape[1:])) if codec != "quant8" else 0
          for leaf in leaves]
    m = leaves[0].shape[0] if leaves else 0
    with counted("delta_codec", m=m,
                 d=sum(math.prod(x.shape[1:]) for x in leaves)):
        outs: list = [None] * len(leaves)
        groups: dict = {}
        for i, (leaf, ref_leaf) in enumerate(zip(leaves, refs, strict=True)):
            if use_kernel(leaf):
                groups.setdefault(leaf.device, []).append(i)
                continue
            m, d = leaf.shape[0], math.prod(leaf.shape[1:])
            delta = leaf.reshape(m, d) - ref_leaf.reshape(1, d)
            rt = delta_codec_ref(delta, codec, ks[i])
            outs[i] = (ref_leaf.reshape(1, d) + rt).reshape(leaf.shape)
        for device, idx in groups.items():
            if device.type == "meta":
                for i in idx:
                    outs[i] = torch.empty_like(leaves[i])
                continue
            for i, out in zip(idx, delta_codec_leaves_cuda(
                    [leaves[i].contiguous() for i in idx],
                    [refs[i].contiguous() for i in idx], codec,
                    [ks[i] for i in idx])):
                outs[i] = out
    return tree_unflatten(stacked, outs)
