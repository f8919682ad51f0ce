"""Client-parallel FL simulation: one round as one batched step
(counterpart of `repro/federated/sim.py`).

`parallel_client_round` trains an already-gathered cohort as one batch
(`engine/batch_client.py`) and averages it; `device_selected_round`
extends the step upward through the strategy layer: select -> gather ->
train -> aggregate in one call, the single-round building block of the
whole-run scan engine, exposed standalone.  Neither is on the engines'
path.

The reference's keys become draws: the round's selection draw, minibatch
rows and noise leaves come from `RunDraws.round(t, ...)`, as in the
engines.
"""
from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.core.aggregation import normalized_weights, weighted_average
from repro_torch.core.selection import (
    DeviceSelectionContext, DeviceSelectorState, SelectorSpec, device_select,
    device_update,
)
from repro_torch.engine.batch_client import (
    batched_client_update, cohort_update,
)
from repro_torch.engine.round_engine import RoundSpec, round_plan
from repro_torch.federated.client import ClientConfig
from repro_torch.federated.draws import RunDraws, minibatch_rows
from repro_torch.models.mlp_cnn import ClassifierModel

Params = Any


def parallel_client_round(
    model: ClassifierModel,
    ccfg: ClientConfig,
    params: Params,               # server model w^t
    xs: torch.Tensor,             # (M, cap, ...) selected clients' data
    ys: torch.Tensor,             # (M, cap)
    n_valid: torch.Tensor,        # (M,)
    epochs_k: np.ndarray,         # (M,) straggler-adjusted local epochs
    sigma_k: torch.Tensor,        # (M,) privacy noise levels
    idx: torch.Tensor,            # (M, E*B, batch) minibatch rows
    noise: Sequence[torch.Tensor],  # leaves (M, *shape)
) -> tuple[Params, Params]:
    """Run all M ClientUpdates as one batch; return (stacked updates,
    w^{t+1})."""
    stacked = batched_client_update(model, ccfg, params, xs, ys, epochs_k,
                                    sigma_k, idx, noise)
    with torch.no_grad():
        new_params = weighted_average(
            stacked, normalized_weights(n_valid.to(torch.float32)))
    return stacked, new_params


def device_selected_round(
    model: ClassifierModel,
    ccfg: ClientConfig,
    spec: SelectorSpec,
    params: Params,               # server model w^t
    xs_all: torch.Tensor,         # (N, cap, ...) all clients' padded data
    ys_all: torch.Tensor,         # (N, cap)
    nv_all: torch.Tensor,         # (N,)
    sigma_all: torch.Tensor,      # (N,)
    epochs_all: np.ndarray,       # (N,) this round's epoch budgets
    state: DeviceSelectorState,
    ctx: DeviceSelectionContext,
    draws: RunDraws,
    t: int,
) -> tuple[torch.Tensor, DeviceSelectorState, Params]:
    """Select -> gather -> train -> aggregate for round t.  Returns (sel,
    selector state with bumped counts, w^{t+1}).  SV-driven strategies feed
    their valuation separately through `device_update` once the round's
    Shapley values exist."""
    rd = draws.round(t, round_plan(RoundSpec(), ccfg, (spec,),
                                   spec.n_clients, spec.m, params,
                                   nv_all.cpu().numpy())).to(nv_all.device)
    sel, state = device_select(spec, state, ctx, rd.selection)
    sel_host = sel.cpu().numpy()
    stacked, n_k_sel = cohort_update(
        model, ccfg, params, xs_all, ys_all, nv_all, sigma_all, sel_host,
        np.asarray(epochs_all)[sel_host], minibatch_rows(rd.rows, sel, nv_all),
        rd.noise)
    with torch.no_grad():
        new_params = weighted_average(stacked, normalized_weights(n_k_sel))
    state = device_update(spec, state, sel)
    return sel, state, new_params
