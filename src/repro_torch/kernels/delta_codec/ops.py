"""Public wrapper: the upload-codec roundtrip on a stacked cohort tree
(counterpart of `repro/kernels/delta_codec/ops.py`).

`delta_codec_roundtrip(stacked, params, codec)`: for each leaf, the
(M, *s) client weights minus the (*s,) server weights become an (M, d)
delta matrix, roundtripped rowwise, and added back.  The sparse codecs keep
`leaf_topk_k(d)` entries per row, the per-leaf codecs' rule, so the result
equals `federated.compression`'s per-client roundtrip bitwise.  A CUDA leaf
goes to the CUDA kernel whatever its width (the reference's 2048 <= d <=
2^18 window exists only for its VMEM-resident row); a CPU leaf goes to the
plain version.
"""
from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.kernels import use_kernel
from repro_torch.kernels.delta_codec.kernel import delta_codec_cuda
from repro_torch.kernels.delta_codec.ref import delta_codec_ref
from repro_torch.tree import tree_map

Tree = Any


def delta_codec_roundtrip(stacked: Tree, params: Tree, codec: str) -> Tree:
    """stacked leaves (M, *s), params leaves (*s,) -> roundtripped stack."""
    # deferred: importing repro_torch.federated runs its server module
    from repro_torch.federated.compression import leaf_topk_k

    if codec == "identity":
        return stacked

    def one(leaf: torch.Tensor, ref_leaf: torch.Tensor) -> torch.Tensor:
        m = leaf.shape[0]
        d = math.prod(leaf.shape[1:])
        delta = leaf.reshape(m, d) - ref_leaf.reshape(1, d)
        k = leaf_topk_k(d) if codec != "quant8" else 0
        if use_kernel(leaf):
            rt = delta_codec_cuda(delta.contiguous(), codec, k)
        else:
            rt = delta_codec_ref(delta, codec, k)
        return (ref_leaf.reshape(1, d) + rt).reshape(leaf.shape)

    return tree_map(one, stacked, params)
