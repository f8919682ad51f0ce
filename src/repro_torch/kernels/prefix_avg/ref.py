"""Plain PyTorch version of the prefix_avg kernel (counterpart of
`repro/kernels/prefix_avg/ref.py`).

The walk accumulates strictly left to right, one position at a time, as
`acc = acc + s * g; out = acc / n` with one rounding per operation, and so
does its running size n.  That add order is the contract the CUDA kernel
keeps bit for bit (it uses non-contracting `__fmul_rn`/`__fadd_rn`/
`__fdiv_rn`), and it is the order the reference's `lax.scan` ref states
(its running sizes are a `jnp.cumsum`, which equals the left-to-right sum
for the integer counts it is given).
"""
from __future__ import annotations

import torch


def walk_weights(perms: torch.Tensor, n_k: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """(R, M) walks -> (scale, ncum), both (R, M) float32: n_k gathered in
    walk order and its running sum, added strictly left to right with one
    float32 rounding per position, as the CUDA kernel forms it (exact for
    integer counts below 2^24)."""
    scale = n_k.to(torch.float32)[perms]
    ncum = scale.clone()
    for j in range(1, scale.shape[1]):
        ncum[:, j] = ncum[:, j - 1] + scale[:, j]
    return scale, ncum


def prefix_avg_ref(stacked: torch.Tensor, perms: torch.Tensor,
                   n_k: torch.Tensor) -> torch.Tensor:
    """stacked (M, D) x perms (R, M) x n_k (M,) -> (R*M, D) prefix models in
    float32 accumulation; row r*M + j averages the prefix perms[r, :j+1]."""
    r, m = perms.shape
    scale, ncum = walk_weights(perms, n_k)
    out = torch.empty((r, m, stacked.shape[1]), dtype=stacked.dtype,
                      device=stacked.device)
    acc = torch.zeros((r, stacked.shape[1]), dtype=torch.float32,
                      device=stacked.device)
    for j in range(m):
        g = stacked[perms[:, j]].to(torch.float32)            # (R, D)
        acc = acc + scale[:, j, None] * g
        out[:, j] = (acc / ncum[:, j, None]).to(stacked.dtype)
    return out.reshape(r * m, -1)
