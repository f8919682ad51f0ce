"""Carrying parameters and optimizer states across: numpy nested dicts <->
the port's trees.

A reference model's params become the port's with
`params_from_numpy(jax.tree.map(np.asarray, params))`; the port's own go
back with `params_to_numpy`.  An optimizer state (the reference's or the
port's `AdamWState` / `SGDState`, a named tuple of such trees, its numpy
leaves made with the same `jax.tree.map`) is carried field by field into
the port's class of that name, and back into the port's class with numpy
leaves.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.optim import AdamWState, SGDState
from repro_torch.tree import tree_map

_STATES = {"AdamWState": AdamWState, "SGDState": SGDState}


def _carry(fn, tree: Any) -> Any:
    """`fn` over the leaves of a tree, or of each field of an optimizer
    state (rebuilt as the port's class of the same name)."""
    cls = _STATES.get(type(tree).__name__)
    if cls is not None and isinstance(tree, tuple):
        return cls(*(tree_map(fn, field) for field in tree))
    return tree_map(fn, tree)


def params_from_numpy(tree: Any, device="cpu") -> Any:
    """Nested dict of arrays (or an optimizer state of them) -> the same
    of tensors (copies the data)."""
    return _carry(lambda a: torch.tensor(np.asarray(a), device=device), tree)


def params_to_numpy(tree: Any) -> Any:
    """Nested dict of tensors (or an optimizer state of them) -> the same
    of numpy arrays on the host."""
    return _carry(lambda t: t.detach().cpu().numpy(), tree)
