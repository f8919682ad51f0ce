"""Device GTG-Shapley estimators (counterpart of
`repro/core/shapley_batched.py`): the streaming walk, the default SV path,
and the dense oracle.

Along a permutation walk the prefix ModelAverage is a running sum
(S_j = S_{j-1} + n_{pi(j)} w_{pi(j)}, wbar_j = S_j / N_j), so the
`prefix_avg` kernel builds every prefix model of R walks in O(R*M*D), and
the `ce_loss` kernel scores them all in one batched forward
(`make_batched_mlp_utility`).  `sv_chunk` walks the permutations a chunk at
a time to bound peak memory.  Between-round truncation (|v_M - v_0| < eps)
is a host `if`; within-round truncation is dropped, as in the reference.

The walks are an input (`_draw_perms` makes them from a generator; a test
injects the reference's).  The dense oracle `gtg_shapley_batched`
(`shapley_impl="batched"`) takes the same walks, materialises the
(R*M, M) prefix-weight matrix and contracts it against the stacked
updates with the `weighted_avg` kernel: the two estimators compute the
same Monte-Carlo average and differ only in float association.

A captured round (`engine="scan"`) cannot branch on the truncation test
or read the card back, so with `skip_truncated=False` the estimators
compute the walk whatever the test says and select on the device: a
truncated round gives zero SVs and 2 utility evals, as the reference's
`lax.cond` does; only the time differs.  Their stats are then () device
tensors.  `checked=True` says the walks and the validation labels were
range-checked where they were made, so the kernel wrappers read nothing
back.  The host engines keep the defaults: the test is read on the host
and a truncated round skips the walk.
"""
from __future__ import annotations

import time
from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.aggregation import subset_average
from repro_torch.core.shapley import (
    ShapleyStats, gtg_shapley, permutation_block,
)
from repro_torch.device import synchronize
from repro_torch.kernels.ce_loss.ops import ce_loss
from repro_torch.kernels.prefix_avg.ops import prefix_avg
from repro_torch.kernels.weighted_avg.ops import weighted_avg
from repro_torch.tree import tree_map

Params = Any

# "streaming" (prefix walk, the default) | "batched" (dense oracle) |
# "serial" (Alg. 2 with within-round truncation: a host loop, or the
# device form under the captured round)
SHAPLEY_IMPLS = ("streaming", "batched", "serial")


def prefix_weight_matrix(perms: torch.Tensor,
                         n_k: torch.Tensor) -> torch.Tensor:
    """(R, M) walks -> (R, M, M) normalised prefix-subset weights: row
    (r, j) holds the ModelAverage weights of the subset perms[r, :j+1]."""
    m = perms.shape[1]
    onehot = F.one_hot(perms.to(torch.int64), m).to(torch.float32)
    w = torch.cumsum(onehot, dim=1) * n_k.to(torch.float32)[None, None, :]
    return w / torch.clamp_min(torch.sum(w, dim=-1, keepdim=True), 1e-12)


def _draw_perms(gen: torch.Generator, m: int, n_perms: int) -> torch.Tensor:
    """(R, M) permutation walks: whole (M, M) balanced batches (each client
    first exactly once per batch), rows shuffled, cut to n_perms."""
    n_batches = -(-n_perms // m)
    perms = permutation_block(gen, m, n_batches)
    order = torch.randperm(n_batches * m, generator=gen)
    return perms[order][:n_perms]


def _walk_sv(vs: torch.Tensor, perms: torch.Tensor, v0: torch.Tensor,
             n_perms: int, m: int) -> torch.Tensor:
    """(R, M) walk utilities -> (M,) SV: marginals along each walk, put back
    in client slots and averaged over permutations.

    Each walk is a permutation, so scattering its marginals into a
    client-major (R, M) table writes every slot once; the sum over R is
    then deterministic (an `index_add_` on CUDA would add in atomic,
    run-dependent order).
    """
    v_prev = torch.cat([v0.reshape(1, 1).expand(n_perms, 1), vs[:, :-1]],
                       dim=1)
    marginals = vs - v_prev                              # (R, M) along walk
    table = torch.zeros_like(marginals).scatter_(1, perms, marginals)
    return torch.sum(table, dim=0) / n_perms


def _round_stats(truncated, n_evals: int, n_perms: int, v0: torch.Tensor,
                 v_m: torch.Tensor) -> ShapleyStats:
    """`iterations` reports the permutations actually walked — 0 when
    between-round truncation skipped the whole MC run.  A host `truncated`
    gives host stats; a device one, () device tensors and no host read."""
    if isinstance(truncated, torch.Tensor):
        zero = torch.zeros((), dtype=torch.int32, device=v0.device)
        return ShapleyStats(
            iterations=torch.where(truncated, zero, n_perms),
            utility_evals=torch.where(truncated, zero, n_evals) + 2,
            v0=v0, vM=v_m, truncated_round=truncated)
    return ShapleyStats(iterations=0 if truncated else n_perms,
                        utility_evals=n_evals + 2, v0=float(v0),
                        vM=float(v_m), truncated_round=truncated)


def _truncation(v0: torch.Tensor, v_m: torch.Tensor, eps: float,
                skip_truncated: bool):
    """The between-round test |v_M - v_0| < eps in float32: a host bool
    when the caller skips truncated rounds, else a () device tensor."""
    truncated = torch.abs(v_m - v0) < float(np.float32(eps))
    return bool(truncated) if skip_truncated else truncated


def _finish(sv: torch.Tensor, truncated, n_evals: int, n_perms: int,
            v0: torch.Tensor, v_m: torch.Tensor):
    """A walked round's (sv, stats); zero SVs where a device test says the
    round was truncated."""
    if isinstance(truncated, torch.Tensor):
        sv = torch.where(truncated, torch.zeros_like(sv), sv)
    return sv, _round_stats(truncated, n_evals, n_perms, v0, v_m)


def chunk_walks_for(sv_chunk: int, n_perms: int, m: int,
                    device: torch.device) -> int:
    """Walks evaluated per step: `sv_chunk` = 0 is auto (all R*M models at
    once on CUDA, one walk on the CPU), < 0 forces the all-resident pass,
    c > 0 rounds c models up to whole walks."""
    if sv_chunk == 0:
        return n_perms if device.type == "cuda" else 1
    if sv_chunk < 0:
        return n_perms
    return min(max(1, -(-sv_chunk // m)), n_perms)


def gtg_shapley_streaming(
    stacked_updates: Params,
    n_k: torch.Tensor,
    w_prev: Params,
    utility_fn: Callable[[Params], torch.Tensor],
    batched_utility_fn: Callable[[Params], torch.Tensor],
    perms: torch.Tensor,
    *,
    eps: float = 1e-4,
    sv_chunk: int = 0,
    skip_truncated: bool = True,
    checked: bool = False,
) -> tuple[torch.Tensor, ShapleyStats]:
    """Streaming SV estimate over the (R, M) walks `perms`.

    Chunk boundaries fall on whole walks and each walk accumulates left to
    right, so chunking changes only how many models are resident at once.
    Filler walks that pad the last chunk are evaluated and discarded, and
    counted in `utility_evals`, as the reference counts them.
    """
    m = int(n_k.shape[0])
    n_perms = int(perms.shape[0])
    device = n_k.device
    with torch.no_grad():
        w_full = subset_average(stacked_updates, n_k,
                                torch.ones((m,), device=device))
        v0 = utility_fn(w_prev)
        v_m = utility_fn(w_full)
        truncated = _truncation(v0, v_m, eps, skip_truncated)
        if truncated is True:
            return (torch.zeros((m,), device=device),
                    _round_stats(True, 0, n_perms, v0, v_m))

        chunk_walks = chunk_walks_for(sv_chunk, n_perms, m, device)
        n_chunks = -(-n_perms // chunk_walks)
        pad_walks = n_chunks * chunk_walks - n_perms
        perms = perms.to(device=device, dtype=torch.int64)
        if pad_walks:
            filler = torch.arange(m, device=device).expand(pad_walks, m)
            perms_padded = torch.cat([perms, filler])
        else:
            perms_padded = perms
        vs = torch.cat([
            batched_utility_fn(prefix_avg(
                stacked_updates,
                perms_padded[c * chunk_walks:(c + 1) * chunk_walks], n_k,
                checked=checked))
            for c in range(n_chunks)])[: n_perms * m]
        sv = _walk_sv(vs.reshape(n_perms, m), perms, v0, n_perms, m)
    return _finish(sv, truncated, n_chunks * chunk_walks * m, n_perms, v0,
                   v_m)


def gtg_shapley_batched(
    stacked_updates: Params,
    n_k: torch.Tensor,
    w_prev: Params,
    utility_fn: Callable[[Params], torch.Tensor],
    batched_utility_fn: Callable[[Params], torch.Tensor],
    perms: torch.Tensor,
    *,
    eps: float = 1e-4,
    use_kernel: bool = True,
    skip_truncated: bool = True,
) -> tuple[torch.Tensor, ShapleyStats]:
    """Dense SV estimate over the (R, M) walks `perms`: all R*M prefix
    models in one contraction, kept as the parity oracle of the streaming
    estimator.  `use_kernel=False` takes the reference's tensordot branch."""
    m = int(n_k.shape[0])
    n_perms = int(perms.shape[0])
    device = n_k.device
    with torch.no_grad():
        w_full = subset_average(stacked_updates, n_k,
                                torch.ones((m,), device=device))
        v0 = utility_fn(w_prev)
        v_m = utility_fn(w_full)
        truncated = _truncation(v0, v_m, eps, skip_truncated)
        if truncated is True:
            return (torch.zeros((m,), device=device),
                    _round_stats(True, 0, n_perms, v0, v_m))

        perms = perms.to(device=device, dtype=torch.int64)
        flat_w = prefix_weight_matrix(perms, n_k).reshape(n_perms * m, m)
        if use_kernel:
            models = weighted_avg(stacked_updates, flat_w)
        else:
            models = tree_map(lambda leaf: torch.tensordot(
                flat_w.to(leaf.dtype), leaf, dims=1), stacked_updates)
        vs = batched_utility_fn(models).reshape(n_perms, m)
        sv = _walk_sv(vs, perms, v0, n_perms, m)
    return _finish(sv, truncated, n_perms * m, n_perms, v0, v_m)


def make_batched_mlp_utility(model, x_val: torch.Tensor, y_val: torch.Tensor,
                             *, checked: bool = False):
    """-(val CE) of every model in a batch stacked on a leading axis, one
    batched forward and one `ce_loss` call for the whole batch (`checked`:
    the labels were range-checked beforehand)."""
    def utility(params_b):
        with torch.no_grad():
            return -ce_loss(model.apply_batched(params_b, x_val), y_val,
                            checked=checked)

    return utility


def shapley_stage(
    impl: str,
    stacked_updates: Params,
    n_k: torch.Tensor,
    w_prev: Params,
    utility_fn: Callable[[Params], torch.Tensor],
    batched_utility_fn: Callable[[Params], torch.Tensor],
    walks,
    *,
    eps: float,
    max_iters: int,
    sv_chunk: int,
) -> tuple[torch.Tensor, ShapleyStats, float]:
    """One round's SV by the estimator `impl`, the stage both engines run.

    `walks` is the (R, M) walk tensor of the streaming and dense
    estimators, or the serial estimator's (max_iters * M, M) block.  Returns
    (sv, stats, seconds), the seconds taken between two device
    synchronisations.
    """
    if impl not in SHAPLEY_IMPLS:
        raise ValueError(f"unknown shapley_impl {impl!r}; "
                         f"options: {SHAPLEY_IMPLS}")
    synchronize(n_k.device)
    t0 = time.perf_counter()
    if impl == "streaming":
        sv, stats = gtg_shapley_streaming(
            stacked_updates, n_k, w_prev, utility_fn, batched_utility_fn,
            walks, eps=eps, sv_chunk=sv_chunk)
    elif impl == "batched":
        sv, stats = gtg_shapley_batched(
            stacked_updates, n_k, w_prev, utility_fn, batched_utility_fn,
            walks, eps=eps)
    else:
        sv, stats = gtg_shapley(stacked_updates, n_k, w_prev, utility_fn,
                                walks, eps=eps, max_iters=max_iters)
    synchronize(n_k.device)
    return sv, stats, time.perf_counter() - t0
