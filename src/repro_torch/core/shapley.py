"""GTG-Shapley (Alg. 2) — server-side fast Shapley-Value approximation.

Counterpart of `repro/core/shapley.py`, as a host loop.  Monte-Carlo
permutation sampling with two truncations:
  * between-round: if |U(w^{t+1}) - U(w^t)| < eps, all SVs are zero this round;
  * within-round: while scanning a permutation, once |v_M - v_j| < eps the
    remaining marginal contributions are taken as zero (v carried forward),
    and the utility evaluation is skipped.

Utility U(S) = utility_fn(ModelAverage over subset S), with the empty subset
mapped to the previous server model w^t (v_0).
"""
from __future__ import annotations

import itertools
import math
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core.aggregation import subset_average

Params = Any
UtilityFn = Callable[[Params], torch.Tensor]  # params -> scalar utility


class ShapleyStats(NamedTuple):
    # MC rounds (serial) / permutations (streaming) actually walked — 0
    # when between-round truncation skipped the whole MC run
    iterations: int
    utility_evals: int         # number of non-truncated utility evaluations
    v0: float                  # U(w^t)
    vM: float                  # U(w^{t+1})
    truncated_round: bool      # between-round truncation fired


def _permutation_batch(gen: torch.Generator, m: int) -> torch.Tensor:
    """(M, M) int64 on `gen`'s device: row k is a permutation of [M] with
    first element k."""
    rows = []
    for k in range(m):
        others = torch.tensor([i for i in range(m) if i != k],
                              dtype=torch.int64)
        rest = others[torch.randperm(m - 1, generator=gen)]
        rows.append(torch.cat([torch.tensor([k]), rest]))
    return torch.stack(rows)


def gtg_shapley(stacked_updates: Params, n_k: torch.Tensor, w_prev: Params,
                utility_fn: UtilityFn,
                perm_batch: Callable[[], torch.Tensor], *,
                eps: float = 1e-4, max_iters: int | None = None,
                convergence_tol: float = 0.05,
                convergence_rounds: int = 3
                ) -> tuple[torch.Tensor, ShapleyStats]:
    """Approximate SV of each of the M stacked client updates.

    stacked_updates: tree with leaves (M, *shape) — client models w_k^{t+1}.
    n_k: (M,) dataset sizes for ModelAverage weights.
    perm_batch: returns the next (M, M) batch of walks, one MC round each.
    Returns (sv: (M,) float32, stats).
    """
    m = int(n_k.shape[0])
    device = n_k.device
    if max_iters is None:
        max_iters = 50 * m  # paper: T = 50 * |S|

    with torch.no_grad():
        w_full = subset_average(stacked_updates, n_k,
                                torch.ones((m,), device=device))
        eps32, tol32 = np.float32(eps), np.float32(convergence_tol)
        v0 = np.float32(float(utility_fn(w_prev)))   # float(): any device
        v_m = np.float32(float(utility_fn(w_full)))
        if abs(v_m - v0) < eps32:                 # between-round truncation
            return (torch.zeros((m,), device=device),
                    ShapleyStats(0, 2, float(v0), float(v_m), True))

        # host float32 bookkeeping, in the reference's order of operations
        sv_sum = np.zeros((m,), np.float32)
        sv_prev = np.zeros((m,), np.float32)
        count = stall = tau = n_evals = 0
        while tau < max_iters:
            round_contrib = np.zeros((m,), np.float32)
            for perm in perm_batch().tolist():
                v_j = v0
                mask = torch.zeros((m,), device=device)
                contrib = np.zeros((m,), np.float32)
                for k in perm:
                    mask[k] = 1.0
                    if abs(v_m - v_j) < eps32:  # within-round truncation
                        v_next = v_j
                    else:
                        v_next = np.float32(float(utility_fn(
                            subset_average(stacked_updates, n_k, mask))))
                        n_evals += 1
                    contrib[k] += v_next - v_j
                    v_j = v_next
                round_contrib = round_contrib + contrib
            sv_sum = sv_sum + round_contrib
            count += m
            tau += 1
            sv_now = sv_sum / np.float32(count)
            denom = max(np.max(np.abs(sv_now)), eps32)
            rel_change = np.max(np.abs(sv_now - sv_prev)) / denom
            stall = stall + 1 if rel_change < tol32 else 0
            sv_prev = sv_now
            if stall >= convergence_rounds:
                break
        sv = sv_sum / np.float32(max(count, 1))
    return (torch.as_tensor(sv, device=device),
            ShapleyStats(tau, n_evals + 2, float(v0), float(v_m), False))


def exact_shapley(stacked_updates: Params, n_k: torch.Tensor, w_prev: Params,
                  utility_fn: UtilityFn) -> torch.Tensor:
    """Brute-force SV over all 2^M subsets (test oracle; M <= ~10)."""
    m = int(n_k.shape[0])
    device = n_k.device

    def u_of_mask(mask_tuple):
        if not any(mask_tuple):
            return float(utility_fn(w_prev))
        mask = torch.tensor(mask_tuple, dtype=torch.float32, device=device)
        return float(utility_fn(subset_average(stacked_updates, n_k, mask)))

    cache: dict[tuple, float] = {}

    def u(mask_tuple):
        if mask_tuple not in cache:
            cache[mask_tuple] = u_of_mask(mask_tuple)
        return cache[mask_tuple]

    sv = [0.0] * m
    with torch.no_grad():
        for k in range(m):
            others = [i for i in range(m) if i != k]
            for r in range(m):
                for subset in itertools.combinations(others, r):
                    base = tuple(1 if i in subset else 0 for i in range(m))
                    with_k = tuple(1 if (i in subset or i == k) else 0
                                   for i in range(m))
                    weight = 1.0 / (m * math.comb(m - 1, r))
                    sv[k] += weight * (u(with_k) - u(base))
    return torch.tensor(sv, device=device)
