"""GTG-Shapley (Alg. 2) — server-side fast Shapley-Value approximation.

Counterpart of `repro/core/shapley.py`.  Monte-Carlo permutation sampling
with two truncations:
  * between-round: if |U(w^{t+1}) - U(w^t)| < eps, all SVs are zero this round;
  * within-round: while scanning a permutation, once |v_M - v_j| < eps the
    remaining marginal contributions are taken as zero (v carried forward),
    and the utility evaluation is skipped.

Utility U(S) = utility_fn(ModelAverage over subset S), with the empty subset
mapped to the previous server model w^t (v_0).

Two forms of one computation on one round's walk block (`permutation_block`,
drawn before the round, so it does not depend on convergence): `gtg_shapley`,
a host loop that reads every utility back (the loop and batched engines),
and `gtg_shapley_device`, which reads nothing back (the scan's captured
round: a CUDA-graph WHILE node over the MC rounds with an IF node a step).
They give the same bits.
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


def permutation_block(gen: torch.Generator, m: int,
                      n_batches: int) -> torch.Tensor:
    """(n_batches * M, M) int64 host tensor, the serial estimator's walks
    for one round: batch tau is rows [tau M, tau M + M), and row k of
    each batch is a permutation of [M] with first element k.  One
    vectorised draw: each row's other M - 1 clients in the order of a
    stable argsort of uniform keys."""
    first = torch.arange(m, dtype=torch.int64).repeat(n_batches)
    keys = torch.rand((n_batches * m, m - 1), generator=gen)
    rest = torch.argsort(keys, dim=1, stable=True)
    rest = rest + (rest >= first[:, None]).to(torch.int64)
    return torch.cat([first[:, None], rest], dim=1)


def _walk_batches(walks: torch.Tensor, m: int,
                  max_iters: int) -> torch.Tensor:
    """The (max_iters, M, M) batches of a round's walk block."""
    if walks.dim() != 2 or walks.shape[1] != m or \
            walks.shape[0] < max_iters * m:
        raise ValueError(f"the serial estimator takes a ({max_iters * m}, "
                         f"{m}) walk block (max_iters batches of M walks), "
                         f"got {tuple(walks.shape)}")
    return walks[:max_iters * m].reshape(max_iters, m, m)


def gtg_shapley(stacked_updates: Params, n_k: torch.Tensor, w_prev: Params,
                utility_fn: UtilityFn, walks: torch.Tensor, *,
                eps: float = 1e-4, max_iters: int | None = None,
                convergence_tol: float = 0.05,
                convergence_rounds: int = 3
                ) -> tuple[torch.Tensor, ShapleyStats]:
    """Approximate SV of each of the M stacked client updates: the host
    form, which reads every utility back.

    stacked_updates: tree with leaves (M, *shape) — client models w_k^{t+1}.
    n_k: (M,) dataset sizes for ModelAverage weights.
    walks: the round's (max_iters * M, M) walk block
    (`permutation_block`); MC round tau walks batch tau.
    Returns (sv: (M,) float32, stats).
    """
    m = int(n_k.shape[0])
    device = n_k.device
    if max_iters is None:
        max_iters = 50 * m  # paper: T = 50 * |S|
    batches = _walk_batches(walks, m, max_iters)

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
            for perm in batches[tau].tolist():
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


def gtg_shapley_device(stacked_updates: Params, n_k: torch.Tensor,
                       w_prev: Params, utility_fn: UtilityFn,
                       walks: torch.Tensor, *, eps: float = 1e-4,
                       max_iters: int | None = None,
                       convergence_tol: float = 0.05,
                       convergence_rounds: int = 3
                       ) -> tuple[torch.Tensor, ShapleyStats]:
    """`gtg_shapley` with no host read, the form a captured round holds.

    The MC rounds are a `graph_flow.while_` and each walk step's utility
    an `graph_flow.if_` on "not truncated": on the card, while a graph is
    captured, a WHILE node and M^2 IF nodes inside it, so a truncated
    step or round does no work; elsewhere a masked unroll of max_iters
    passes with the same values.  Between-round truncation makes the
    WHILE's flag false before its first pass.  The bookkeeping is the host
    form's float32 arithmetic in its order (division by float32 tensors,
    comparisons against float32 eps and tolerance), and each utility the
    same `subset_average` and `utility_fn` calls, so both forms give the
    same bits.  The MC carry lives in tensors made before the loop and is
    updated in place.  Stats are () device tensors: `iterations` and
    `utility_evals` int32, `truncated_round` bool.
    """
    from repro_torch.engine.graph_flow import if_, while_

    m = int(n_k.shape[0])
    device = n_k.device
    if max_iters is None:
        max_iters = 50 * m  # paper: T = 50 * |S|
    batches = _walk_batches(walks, m, max_iters).to(device=device,
                                                     dtype=torch.int64)

    def f32(x):
        return torch.full((), x, dtype=torch.float32, device=device)

    def i32(x):
        return torch.full((), x, dtype=torch.int32, device=device)

    with torch.no_grad():
        w_full = subset_average(stacked_updates, n_k,
                                torch.ones((m,), device=device))
        eps32, tol32 = f32(eps), f32(convergence_tol)
        v0 = utility_fn(w_prev).to(torch.float32)
        v_m = utility_fn(w_full).to(torch.float32)
        truncated = torch.abs(v_m - v0) < eps32   # between-round truncation
        slots = torch.arange(m, device=device)
        # the carry of the MC rounds, written in place by each pass
        sv_sum = torch.zeros((m,), device=device)
        sv_prev = torch.zeros((m,), device=device)
        count, tau, stall, n_evals = i32(0), i32(0), i32(0), i32(0)
        go = torch.logical_not(truncated) & (tau < max_iters)

        def mc_round():
            batch = batches.index_select(0, tau.to(torch.int64)
                                         .reshape(1))[0]
            round_contrib = torch.zeros((m,), device=device)
            round_evals = i32(0)
            for w in range(m):
                v_j = v0
                mask = torch.zeros((m,), device=device)
                contrib = torch.zeros((m,), device=device)
                for j in range(m):
                    hit = slots == batch[w, j]
                    mask = torch.where(hit, 1.0, mask)
                    # within-round truncation skips the evaluation
                    active = torch.logical_not(torch.abs(v_m - v_j) < eps32)
                    v_next = v_j.clone()

                    def evaluate(mask=mask, v_next=v_next):
                        v_next.copy_(utility_fn(subset_average(
                            stacked_updates, n_k, mask)))

                    if_(active, evaluate, (v_next,))
                    round_evals = round_evals + active.to(torch.int32)
                    contrib = torch.where(hit, contrib + (v_next - v_j),
                                          contrib)
                    v_j = v_next
                round_contrib = round_contrib + contrib
            new_sum = sv_sum + round_contrib
            new_count = count + m
            new_tau = tau + 1
            sv_now = new_sum / new_count.to(torch.float32)
            denom = torch.maximum(torch.amax(torch.abs(sv_now)), eps32)
            rel_change = torch.amax(torch.abs(sv_now - sv_prev)) / denom
            new_stall = torch.where(rel_change < tol32, stall + 1, 0)
            n_evals.add_(round_evals)
            for dst, src in ((sv_sum, new_sum), (count, new_count),
                             (tau, new_tau), (stall, new_stall),
                             (sv_prev, sv_now)):
                dst.copy_(src)
            go.copy_((new_tau < max_iters)
                     & (new_stall < convergence_rounds))

        while_(go, mc_round, (sv_sum, sv_prev, count, tau, stall, n_evals),
               max_passes=max_iters)
        sv = sv_sum / torch.clamp_min(count, 1).to(torch.float32)
    return sv, ShapleyStats(iterations=tau, utility_evals=n_evals + 2,
                            v0=v0, vM=v_m, truncated_round=truncated)


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
