"""Cumulative Shapley-Value tracking (Alg. 1, lines 11-12).

Counterpart of `repro/core/valuation.py`.  Two variants from the paper:
  * mean:        SV_k <- ((N_k - 1) SV_k + SV_k^(t)) / N_k
  * exponential: SV_k <- alpha * SV_k + (1 - alpha) * SV_k^(t)
where N_k counts how many times client k has been selected; updates only
apply to clients in S_t.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class ValuationState(NamedTuple):
    sv: torch.Tensor           # (N,) float32 cumulative Shapley value
    counts: torch.Tensor       # (N,) int32 times each client was selected
    initialised: torch.Tensor  # (N,) bool — has the client ever been valued


def init_valuation(n_clients: int, device="cpu") -> ValuationState:
    return ValuationState(
        sv=torch.zeros((n_clients,), dtype=torch.float32, device=device),
        counts=torch.zeros((n_clients,), dtype=torch.int32, device=device),
        initialised=torch.zeros((n_clients,), dtype=torch.bool,
                                device=device),
    )


def bump_counts(counts: torch.Tensor, selected: torch.Tensor) -> torch.Tensor:
    """counts.at[selected].add(1): repeated ids count once per repeat."""
    return counts.index_add(0, selected.to(torch.int64),
                            torch.ones_like(selected, dtype=counts.dtype))


def update_valuation(state: ValuationState, selected: torch.Tensor,
                     sv_round: torch.Tensor, *, mode: str = "mean",
                     alpha: float = 0.5) -> ValuationState:
    """selected (M,) client ids of S_t, sv_round (M,) SV_k^(t)."""
    selected = selected.to(torch.int64)
    counts = bump_counts(state.counts, selected)
    if mode == "mean":
        n_sel = counts[selected].to(torch.float32)
        new_vals = ((n_sel - 1.0) * state.sv[selected] + sv_round) / n_sel
    elif mode == "exponential":
        first = ~state.initialised[selected]
        ema = alpha * state.sv[selected] + (1.0 - alpha) * sv_round
        new_vals = torch.where(first, sv_round, ema)
    else:
        raise ValueError(f"unknown valuation mode: {mode!r}")
    sv = state.sv.index_put((selected,), new_vals.to(torch.float32))
    return ValuationState(sv=sv, counts=counts,
                          initialised=state.initialised.index_fill(
                              0, selected, True))
