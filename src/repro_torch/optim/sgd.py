"""SGD with momentum — the paper's client optimizer (eta=0.01, gamma=0.5).
Counterpart of `repro/optim/sgd.py`."""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.tree import tree_map

Params = Any


class SGDState(NamedTuple):
    momentum: Params


def sgd_init(params: Params) -> SGDState:
    return SGDState(momentum=tree_map(torch.zeros_like, params))


def sgd_step(grads: Params, state: SGDState, params: Params,
             *, lr: float, momentum: float = 0.0) -> tuple[Params, SGDState]:
    new_m = tree_map(lambda m, g: momentum * m + g, state.momentum, grads)
    new_p = tree_map(lambda p, m: p - lr * m, params, new_m)
    return new_p, SGDState(momentum=new_m)
