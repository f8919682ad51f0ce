"""Cohort hardening: fault injection, the quarantine screen, masked SV
weights and masked aggregation (counterpart of
`repro/faults/quarantine.py`), one pipeline every engine runs.

Identity contract: with `faults is None` and `quarantine` off,
`harden_cohort` is a static passthrough (no op at all).  With the screen
on over a clean cohort every mask is all true and each `torch.where` is a
bitwise identity, so quarantine on a clean run is bitwise quarantine off.

SV masking: quarantined rows are replaced by the previous global params
(delta 0) and given the weight TINY_WEIGHT = 2^-100.  In f32 sums that
weight is absorbed exactly by any honest weight >= 1, so a prefix with an
honest client averages bitwise as if the quarantined row were absent; a
walk's all-masked prefix averages 2^-100 * w_prev / 2^-100, which is
w_prev up to the subnormal products of its entries below 2^-26 (the
reference's XLA flushes those to zero; torch and the port's kernels keep
them).  The dense oracle clamps a prefix's weight sum at 1e-12, so there
an all-masked prefix is ~1e-18 * w_prev, as in the reference.  The SVs of
quarantined rows are zeroed after the walk.

Every function is plain tensor code with no host read and no
data-dependent shape, so a captured round can hold it: the screen's
median sorts the masked norms (NaN last), counts the finite ones on the
device and gathers the middle two by device index.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch.core.aggregation import normalized_weights, weighted_average
from repro_torch.faults.spec import (
    CODE_CRASH, CODE_INF, CODE_NAN, CODE_NONE, CODE_SCALE, CODE_SIGN_FLIP,
    FaultSpec,
)
from repro_torch.tree import tree_leaves, tree_map

# the smallest "still participating" SV weight: absorbed exactly (f32) when
# an honest weight >= 1 shares the prefix, yet it keeps an all-masked
# prefix defined (its average is w_prev) instead of 0/0
TINY_WEIGHT = 2.0 ** -100


class HardenedCohort(NamedTuple):
    stacked: Any              # cohort updates, quarantined rows := w_prev
    n_k_agg: torch.Tensor     # (M,) aggregation weights, quarantined := 0
    n_k_sv: torch.Tensor      # (M,) SV-walk weights, quarantined := TINY
    ok: torch.Tensor          # (M,) bool: survived injection and screen
    quarantined: torch.Tensor  # () int32 count of masked rows


def _per_row(a: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Broadcast an (M,) vector against an (M, ...) stacked leaf."""
    return a.reshape((-1,) + (1,) * (like.dim() - 1))


@torch.no_grad()
def apply_faults(stacked, params, codes: torch.Tensor, scale: float):
    """Inject the coded faults into a stacked cohort of client params.

    `codes` is the (M,) gather of the fault table at the cohort.  Code-0
    and CRASH rows (payload intact, masked later) pass through bitwise
    untouched: the guard matters because `p + (w - p) * 1.0` is not
    bitwise `w` in f32.
    """
    def leaf(w, p):
        c = _per_row(codes, w)
        d = w - p[None]
        factor = torch.where(c == CODE_SIGN_FLIP, -scale,
                             torch.where(c == CODE_SCALE, scale, 1.0)
                             ).to(w.dtype)
        faulty = p[None] + d * factor
        faulty = torch.where(c == CODE_NAN, float("nan"), faulty)
        faulty = torch.where(c == CODE_INF, float("inf"), faulty)
        untouched = (c == CODE_NONE) | (c == CODE_CRASH)
        return torch.where(untouched, w, faulty)

    return tree_map(leaf, stacked, params)


def nanmedian(x: torch.Tensor) -> torch.Tensor:
    """() median of the non-NaN entries of the (M,) `x`, as the reference's
    `jnp.nanmedian` computes it (`nanquantile(..., method="midpoint")`):
    with c non-NaN values sorted first, (a[(c-1)//2] + a[c//2]) * 0.5,
    NaN when c == 0.  `torch.nanmedian` takes the lower middle instead."""
    s, _ = torch.sort(x)                           # NaN sorts last
    c = torch.sum(~torch.isnan(x))
    lo = torch.clamp(torch.div(c - 1, 2, rounding_mode="floor"), min=0)
    hi = torch.clamp(torch.minimum(c // 2, c - 1), min=0)
    pair = s.index_select(0, torch.stack([lo, hi]))
    return ((pair[0] + pair[1]) * 0.5).reshape(())


@torch.no_grad()
def screen_cohort(stacked, params, *, z: float,
                  rel_floor: float = 0.1) -> torch.Tensor:
    """(M,) bool quarantine screen over the decoded cohort deltas.

    Two tests per client: every leaf entry finite, and the delta's L2 norm
    under the robust cutoff `median + z * (1.4826*MAD + rel_floor*median +
    1e-6)` over the finite norms.  An all-non-finite cohort gives a NaN
    cutoff, so every client fails the comparison.
    """
    finite, norm, cutoff = screen_stats(stacked, params, z=z,
                                        rel_floor=rel_floor)
    return finite & (norm <= cutoff)


@torch.no_grad()
def screen_stats(stacked, params, *, z: float, rel_floor: float = 0.1):
    """The screen's parts: ((M,) bool all entries finite, (M,) f32 delta
    norms, () f32 cutoff)."""
    ws, ps = tree_leaves(stacked), tree_leaves(params)
    m = ws[0].shape[0]
    device = ws[0].device
    sq = torch.zeros((m,), dtype=torch.float32, device=device)
    finite = torch.ones((m,), dtype=torch.bool, device=device)
    for w, p in zip(ws, ps):
        d = (w - p[None]).reshape(m, -1).to(torch.float32)
        finite = finite & torch.isfinite(d).all(dim=1)
        sq = sq + torch.sum(d * d, dim=1)
    norm = torch.sqrt(sq)
    masked = torch.where(finite, norm, float("nan"))
    med = nanmedian(masked)
    mad = nanmedian(torch.abs(masked - med))
    cutoff = med + z * (1.4826 * mad + rel_floor * med + 1e-6)
    return finite, norm, cutoff


@torch.no_grad()
def harden_cohort(stacked, params, n_k_sel: torch.Tensor,
                  codes: Optional[torch.Tensor], *,
                  faults: Optional[FaultSpec], quarantine: bool,
                  z: float) -> HardenedCohort:
    """Inject, screen and mask.  A static passthrough when both are off."""
    m = n_k_sel.shape[0]
    device = n_k_sel.device
    if faults is None and not quarantine:
        return HardenedCohort(stacked, n_k_sel, n_k_sel,
                              torch.ones((m,), dtype=torch.bool,
                                         device=device),
                              torch.zeros((), dtype=torch.int32,
                                          device=device))
    if faults is not None:
        stacked = apply_faults(stacked, params, codes, faults.scale)
        ok = codes != CODE_CRASH
    else:
        ok = torch.ones((m,), dtype=torch.bool, device=device)
    if quarantine:
        ok = ok & screen_cohort(stacked, params, z=z)
    quarantined = torch.sum(~ok).to(torch.int32)
    # replace masked rows by w_prev BEFORE aggregation and the walk: a NaN
    # row would otherwise poison the average through 0 * NaN = NaN
    stacked = tree_map(lambda w, p: torch.where(_per_row(ok, w), w, p[None]),
                       stacked, params)
    n_k_agg = torch.where(ok, n_k_sel, 0.0)
    n_k_sv = torch.where(ok, n_k_sel, TINY_WEIGHT)
    return HardenedCohort(stacked, n_k_agg, n_k_sv, ok, quarantined)


@torch.no_grad()
def masked_average(stacked, n_k_agg: torch.Tensor, ok: torch.Tensor,
                   params):
    """Aggregate the hardened cohort; an all-quarantined round keeps the
    previous global params (a device select, no host branch)."""
    agg = weighted_average(stacked, normalized_weights(n_k_agg))
    any_ok = torch.any(ok)
    return tree_map(lambda a, p: torch.where(any_ok, a, p), agg, params)
