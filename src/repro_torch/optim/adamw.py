"""AdamW for the LM configs (SGD is too slow to be a realistic LM default).
Counterpart of `repro/optim/adamw.py`, in the reference's order of
operations: moments in float32, `(m / c1) / (sqrt(v / c2) + eps) + wd * p`
in float32, cast back to the param dtype, and `step` an int32 tensor."""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.tree import tree_leaves, tree_map

Params = Any


class AdamWState(NamedTuple):
    mu: Params
    nu: Params
    step: torch.Tensor


def adamw_init(params: Params) -> AdamWState:
    def zeros(p):
        return tree_map(lambda x: torch.zeros_like(x, dtype=torch.float32),
                        p)
    device = tree_leaves(params)[0].device
    return AdamWState(mu=zeros(params), nu=zeros(params),
                      step=torch.zeros((), dtype=torch.int32, device=device))


def adamw_step(grads: Params, state: AdamWState, params: Params, *,
               lr: float, b1: float = 0.9, b2: float = 0.95,
               eps: float = 1e-8, weight_decay: float = 0.0
               ) -> tuple[Params, AdamWState]:
    step = state.step + 1
    sf = step.to(torch.float32)
    c1 = 1.0 - torch.pow(b1, sf)
    c2 = 1.0 - torch.pow(b2, sf)

    mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.to(torch.float32),
                  state.mu, grads)
    nu = tree_map(lambda v, g: b2 * v + (1 - b2) * torch.square(
        g.to(torch.float32)), state.nu, grads)

    def upd(p, m, v):
        pf = p.to(torch.float32)
        u = (m / c1) / (torch.sqrt(v / c2) + eps) + weight_decay * pf
        return (pf - lr * u).to(p.dtype)

    new_p = tree_map(upd, params, mu, nu)
    return new_p, AdamWState(mu=mu, nu=nu, step=step)
