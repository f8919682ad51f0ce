"""Batched ClientUpdate — the cohort of M selected clients trained as one
batch of M models (counterpart of `repro/engine/batch_client.py`).

`cohort_update` gathers the cohort's rows out of the (N, cap, ...) client
stacks with one `cohort_gather` call (host ids on the host engines, device
ids in a captured round), then
`batched_client_update` runs the M local trainings together: params and
momentum live stacked as (M, *shape) leaves, and each SGD step is one
autograd backward over all M clients' losses, one `sgd_step` on the
stacked trees and one stacked straggler mask.

Each client's forward and backward are the loop engine's own ops on a
per-client view of the stacked leaves (one backward call over the M
independent graphs), not a batched matmul: a batched GEMM rounds its sums
differently from the per-client GEMM (up to ~1e-7 per gradient entry on
the H100), and the sparse upload codecs turn such last-bit differences
into a different top-k entry, ~1e-3 apart.  So the batched engine is
bitwise the loop engine, and the codecs, Shapley walk and average after it
agree exactly.  A batch-invariant batched GEMM kernel is later work.

Draws: the minibatch index tables and noise leaves are inputs, made by
`RunDraws.round` for the round's slots (`federated/draws.py`), so every
engine sees the same minibatches and noise.  Stragglers: client k runs
E_k * B of the E * B steps.  The batch runs max_k E_k * B steps, and after
its budget a client keeps both its params and its momentum (the
reference's vmapped `fori_loop` with a batched trip count does the same).
With host budgets (the batched engine) the trip count and the straggler
mask come from the host, and a step where every client is active skips
the mask; with device budgets (a captured round) the caller gives a
static trip count, `n_steps`, and every step applies the device mask
`E_k * B > i`, which keeps a finished client's params and momentum bit
for bit.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence

import numpy as np
import torch

from repro_torch.federated.client import ClientConfig, make_local_loss
from repro_torch.kernels.cohort_gather import cohort_gather
from repro_torch.models.mlp_cnn import ClassifierModel
from repro_torch.optim.sgd import SGDState, sgd_init, sgd_step
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

Params = Any


def batched_client_update(
    model: ClassifierModel,
    ccfg: ClientConfig,
    params: Params,               # server model w^t, shared by the cohort
    xs: torch.Tensor,             # (M, cap, ...) cohort padded data
    ys: torch.Tensor,             # (M, cap)
    epochs_k,                     # (M,) local epochs E_k: host ints, or
                                  # a device tensor (with n_steps)
    sigma_k: torch.Tensor,        # (M,) privacy noise levels
    idx: torch.Tensor,            # (M, E*B, batch) int64 minibatch rows
    noise: Sequence[torch.Tensor],  # leaves (M, *shape) in tree order
    *,
    n_steps: Optional[int] = None,  # trip count (default max_k E_k * B)
) -> Params:
    """The cohort's noisy w_k^{t+1}; leaves come back (M, *shape)."""
    params0 = tree_map(lambda p: p.detach(), params)
    m = xs.shape[0]
    local_loss_fn = make_local_loss(model, ccfg, params0)
    on_host = not isinstance(epochs_k, torch.Tensor)
    if on_host:
        steps_k = np.asarray(epochs_k, np.int64) * ccfg.batches_per_epoch
        if n_steps is None:
            n_steps = int(steps_k.max(initial=0))
    else:
        if n_steps is None:
            raise ValueError("device epoch budgets need a static n_steps")
        steps_k = epochs_k.to(torch.int64) * ccfg.batches_per_epoch
    rows = torch.arange(m, device=xs.device)[:, None]
    p = tree_map(lambda t: t.expand((m,) + t.shape).clone(), params0)
    opt = sgd_init(p)
    n_leaves = len(tree_leaves(p))
    for i in range(n_steps):
        sel_rows = idx[:, i]                                  # (M, batch)
        xb, yb = xs[rows, sel_rows], ys[rows, sel_rows]
        views = [tree_map(lambda t: t[c].detach().requires_grad_(True), p)
                 for c in range(m)]
        with torch.enable_grad():
            losses = [local_loss_fn(views[c], xb[c], yb[c])
                      for c in range(m)]
        flat = torch.autograd.grad(
            losses, [leaf for v in views for leaf in tree_leaves(v)])
        with torch.no_grad():
            g = tree_unflatten(p, [torch.stack(flat[j::n_leaves])
                                   for j in range(n_leaves)])
            new_p, new_opt = sgd_step(g, opt, p, lr=ccfg.lr,
                                      momentum=ccfg.momentum)
            if on_host:
                active = steps_k > i
                if active.all():
                    p, opt = new_p, new_opt
                    continue
                mask = torch.as_tensor(active, device=xs.device)
            else:
                mask = steps_k > i
            # a client past its budget keeps its params and its momentum
            keep = (lambda new, old: torch.where(
                mask.reshape((m,) + (1,) * (new.dim() - 1)), new, old))
            p = tree_map(keep, new_p, p)
            opt = SGDState(tree_map(keep, new_opt.momentum, opt.momentum))

    with torch.no_grad():
        sigma = sigma_k.to(torch.float32)
        return tree_unflatten(p, [
            leaf + sigma.reshape((m,) + (1,) * (leaf.dim() - 1)) * n
            for leaf, n in zip(tree_leaves(p), noise)])


def cohort_update(
    model: ClassifierModel,
    ccfg: ClientConfig,
    params: Params,
    xs_all: torch.Tensor,         # (N, cap, ...) all clients' padded data
    ys_all: torch.Tensor,         # (N, cap)
    nv_all: torch.Tensor,         # (N,)
    sigma_all: torch.Tensor,      # (N,)
    sel,                          # (M,) selected client ids: host ints
                                  # or a device tensor
    epochs_k,                     # (M,) host ints or a device tensor
    idx: torch.Tensor,            # (M, E*B, batch)
    noise: Sequence[torch.Tensor],
    *,
    n_steps: Optional[int] = None,
    error: Optional[torch.Tensor] = None,
    cohort: Optional[dict] = None,
) -> tuple[Params, torch.Tensor]:
    """Gather the cohort out of the full stacks (one `cohort_gather` call,
    one launch on the card; `error` is the device-id gather's error word)
    and train it as one batch.  Returns (stacked updates, n_k of the cohort
    as float32).  A client-sharded round has gathered the cohort already
    (its "xs", "ys", "nv" and "sigma" rows, across the blocks): it passes
    them as `cohort`, and the stacks are not read."""
    if cohort is None:
        cohort = cohort_gather({"xs": xs_all, "ys": ys_all, "nv": nv_all,
                                "sigma": sigma_all}, sel, error=error)
    xs, ys, nv, sg = (cohort[k] for k in ("xs", "ys", "nv", "sigma"))
    stacked = batched_client_update(model, ccfg, params, xs, ys, epochs_k,
                                    sg, idx, noise, n_steps=n_steps)
    return stacked, nv.to(torch.float32)
