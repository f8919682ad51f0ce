"""Weighted model aggregation — the ModelAverage subroutine of GreedyFed.

Counterpart of `repro/core/aggregation.py`.  The M selected clients'
updates are kept stacked along a leading client axis (one tree whose
leaves have shape (M, *param_shape)), and every subset average is a
weighted reduction over that axis.
"""
from __future__ import annotations

import functools
from typing import Any, Optional

import torch

from repro_torch.tree import tree_leaves, tree_map

Params = Any


def tree_stack(trees: list[Params]) -> Params:
    """Stack a list of identically-structured trees along a new axis 0."""
    return tree_map(lambda *xs: torch.stack(xs, dim=0), *trees)


def tree_unstack(stacked: Params, n: int) -> list[Params]:
    return [tree_map(lambda x: x[i], stacked) for i in range(n)]


def normalized_weights(n_k: torch.Tensor,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """lambda_k proportional to n_k over the masked subset, summing to 1.

    Empty subsets return all-zero weights.
    """
    n_k = torch.as_tensor(n_k).to(torch.float32)
    if mask is not None:
        n_k = n_k * mask.to(torch.float32)
    total = torch.sum(n_k)
    return torch.where(total > 0, n_k / torch.clamp_min(total, 1e-12),
                       torch.zeros_like(n_k))


def weighted_average(stacked: Params, weights: torch.Tensor) -> Params:
    """ModelAverage(n_k, w_k): sum_k weights[k] * leaf[k] for every leaf.

    `weights` must already be normalised (see `normalized_weights`).
    """
    def _avg(leaf):
        w = weights.reshape((-1,) + (1,) * (leaf.dim() - 1)).to(leaf.dtype)
        return torch.sum(leaf * w, dim=0)

    return tree_map(_avg, stacked)


def subset_average(stacked: Params, n_k: torch.Tensor,
                   mask: torch.Tensor) -> Params:
    """ModelAverage restricted to the subset `mask` (M,) in {0,1}."""
    return weighted_average(stacked, normalized_weights(n_k, mask))


def model_average(models: list[Params], n_k) -> Params:
    """Non-stacked entry point (server aggregation, Alg. 1 line 9)."""
    return weighted_average(tree_stack(models),
                            normalized_weights(torch.as_tensor(n_k)))


def tree_add(a: Params, b: Params) -> Params:
    return tree_map(torch.add, a, b)


def tree_sub(a: Params, b: Params) -> Params:
    return tree_map(torch.sub, a, b)


def tree_scale(a: Params, s) -> Params:
    return tree_map(lambda x: x * s, a)


def tree_dot(a: Params, b: Params) -> torch.Tensor:
    parts = tree_leaves(tree_map(lambda x, y: torch.sum(x * y), a, b))
    return functools.reduce(torch.add, parts)


def tree_sq_norm(a: Params) -> torch.Tensor:
    return tree_dot(a, a)


def tree_zeros_like(a: Params) -> Params:
    return tree_map(torch.zeros_like, a)


def tree_cast(a: Params, dtype) -> Params:
    return tree_map(lambda x: x.to(dtype), a)


def tree_size(a: Params) -> int:
    return sum(int(x.numel()) for x in tree_leaves(a))
