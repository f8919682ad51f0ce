"""Carrying parameters across: numpy nested dicts <-> the port's params.

A reference model's params become the port's with
`params_from_numpy(jax.tree.map(np.asarray, params))`; the port's own go
back with `params_to_numpy`.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.tree import tree_map


def params_from_numpy(tree: Any, device="cpu") -> dict:
    """Nested dict of arrays -> nested dict of tensors (copies the data)."""
    return tree_map(lambda a: torch.tensor(np.asarray(a), device=device), tree)


def params_to_numpy(tree: Any) -> dict:
    """Nested dict of tensors -> nested dict of numpy arrays on the host."""
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)
