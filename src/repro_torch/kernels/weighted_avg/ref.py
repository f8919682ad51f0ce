"""Plain PyTorch version of the weighted_avg kernel (counterpart of
`repro/kernels/weighted_avg/ref.py`).

The sum runs over the clients in index order from 0 as one chain of
fused multiply-adds, acc = fma(w_k, x_k, acc) with one float32 rounding
each: the CUDA kernel's `fmaf` chain, bit for bit, and the order the
reference's jnp ref and CPU einsum take at these shapes.  A library
product on the card orders its sums by shape (cuBLAS differs in the last
bit on narrow leaves), so the fma is emulated exactly in float64
(`fma_f32`), on the CPU and on the card alike.
"""
from __future__ import annotations

import torch

_ROWS = 1 << 22   # output entries a step: bounds the float64 temporaries


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
            ) -> torch.Tensor:
    """float32 fma(a, b, c) = round(a * b + c), one rounding, elementwise
    (broadcasting).  a * b is exact in float64; s = a * b + c is exact up
    to the TwoSum error e; s rounds to r in float32 correctly unless s
    is a float32 midpoint that e moves off it, which is fixed here."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bb = s - p
    e = (p - (s - bb)) + (c - bb)
    r = s.float()
    d = s - r.double()
    two = r.double() + 2 * d          # the other neighbour, if s is a tie
    tie = (d != 0) & (two.float().double() == two)
    return torch.where(tie & (e != 0) & ((e > 0) == (d > 0)), two.float(), r)


def weighted_avg_ref(stacked: torch.Tensor,
                     weights: torch.Tensor) -> torch.Tensor:
    """stacked (M, D) x weights (R, M) -> (R, D) in f32 accumulation."""
    w = weights.to(torch.float32)
    x = stacked.to(torch.float32)
    out = torch.empty((w.shape[0], x.shape[1]), dtype=torch.float32,
                      device=x.device)
    step = max(1, _ROWS // max(1, x.shape[1]))
    for r0 in range(0, w.shape[0], step):
        rows = w[r0:r0 + step]
        acc = torch.zeros((rows.shape[0], x.shape[1]), dtype=torch.float32,
                          device=x.device)
        for k in range(x.shape[0]):
            acc = fma_f32(rows[:, k, None], x[k], acc)
        out[r0:r0 + step] = acc
    return out.to(stacked.dtype)
