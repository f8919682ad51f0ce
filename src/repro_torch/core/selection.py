"""Client selection — the port's runtime selector stack.

Counterpart of `repro/core/selection_jax.py` (the reference's
`core/selection.py` is a tests-only host oracle and has none).  The six
strategies are select/update pairs over one state and context signature:

    spec  = make_selector_spec("greedyfed", n_clients=N, m=M)
    state = init_device_state(spec, seed, device)
    sel, state = device_select(spec, state, ctx, draw)
    state      = device_update(spec, state, sel, sv)

The state is all tensors on the run's device, its round counter and
freeze flag too, and no strategy reads the card back: the round-robin
phase and the dropout freeze are `torch.where` selects, as in the
reference, so one selection can be captured in a CUDA graph and replayed
round after round.  `device_select_any` / `device_update_any` switch over
a static tuple of specs by a device `strategy_id`.

The random draws of `random`, `power_of_choice` and `s_fedavg` come in as
a `SelectionDraw` (the round's cohort or Gumbel noise), made by a
`federated.draws.RunDraws` before the round, so a test can hand the
reference's own draws to the port.  Every ranking sorts stably, so ties
resolve by client index, as the reference's stable `jnp.argsort` does.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.valuation import (
    ValuationState, bump_counts, init_valuation, update_valuation,
)


class SelectorSpec(NamedTuple):
    """Hashable description of one selection strategy (the union of all
    strategies' hyperparameters; unused ones keep their defaults)."""
    name: str
    n_clients: int
    m: int
    sv_mode: str = "mean"        # cumulative-SV averaging ("mean"|"exponential")
    sv_alpha: float = 0.5
    decay: float = 0.9           # power_of_choice: d decay rate
    d0: int = 0                  # power_of_choice: initial d (resolved)
    c: float = 0.1               # ucb: exploration constant
    temperature: float = 1.0     # s_fedavg: softmax temperature
    drop_frac: float = 0.5       # greedyfed_dropout: fraction dropped

    @property
    def uses_shapley(self) -> bool:
        return self.name in ("s_fedavg", "ucb", "greedyfed",
                             "greedyfed_dropout")

    @property
    def uses_local_losses(self) -> bool:
        return self.name == "power_of_choice"

    @property
    def rr_rounds(self) -> int:
        return int(np.ceil(self.n_clients / self.m))

    @property
    def n_keep(self) -> int:
        """greedyfed_dropout: active-set size after the RR phase (>= m)."""
        return max(self.m, int(round((1.0 - self.drop_frac) * self.n_clients)))

    @property
    def selection_draws(self) -> tuple:
        """The `SelectionDraw` fields the strategy reads."""
        return {"random": ("choice",), "power_of_choice": ("gumbel",),
                "s_fedavg": ("gumbel",)}.get(self.name, ())


class DeviceSelectorState(NamedTuple):
    valuation: ValuationState   # (N,) sv / counts / initialised
    round: torch.Tensor         # () int64 current round t
    rr_order: torch.Tensor      # (N,) int64 fixed random round-robin order
    active: torch.Tensor        # (N,) bool dropout active-mask
    frozen: torch.Tensor        # () bool has the active-mask been frozen


class DeviceSelectionContext(NamedTuple):
    """Per-round inputs any strategy may need (zeros if unused)."""
    data_fractions: torch.Tensor  # (N,) q_k
    local_losses: torch.Tensor    # (N,) loss of w^t per client (PoC)
    poc_d: object                 # this round's candidate count d: an int
                                  # or a () device tensor


class SelectionDraw(NamedTuple):
    """A round's selection randomness, drawn before the round."""
    choice: Optional[torch.Tensor] = None   # (m,) `random`'s cohort
    gumbel: Optional[torch.Tensor] = None   # (N,) PoC / S-FedAvg noise


def init_device_state(spec: SelectorSpec, seed: int = 0,
                      device="cpu") -> DeviceSelectorState:
    """Same numpy rr_order draw as the reference's `init_device_state`."""
    rng = np.random.default_rng(seed)
    return DeviceSelectorState(
        valuation=init_valuation(spec.n_clients, device),
        round=torch.zeros((), dtype=torch.int64, device=device),
        rr_order=torch.as_tensor(rng.permutation(spec.n_clients),
                                 dtype=torch.int64, device=device),
        active=torch.ones((spec.n_clients,), dtype=torch.bool, device=device),
        frozen=torch.zeros((), dtype=torch.bool, device=device),
    )


_STRATEGY_KWARGS = {
    "random": {},
    "power_of_choice": {"decay": 0.9, "d0": None},
    "s_fedavg": {"beta": 0.5, "temperature": 1.0},
    "ucb": {"c": 0.1},
    "greedyfed": {"averaging": "mean", "alpha": 0.5},
    "greedyfed_dropout": {"averaging": "mean", "alpha": 0.5,
                          "drop_frac": 0.5},
}
STRATEGY_ALIASES = {
    "fedavg": "random",
    "fedprox": "random",   # the prox term lives in the client update
}


def strategy_names() -> list:
    """Every accepted `make_selector_spec` name (aliases included)."""
    return sorted(set(_STRATEGY_KWARGS) | set(STRATEGY_ALIASES))


def make_selector_spec(name: str, n_clients: int, m: int,
                       **kw) -> SelectorSpec:
    """Build a SelectorSpec from a registry name + selector kwargs (PoC:
    decay/d0; S-FedAvg: beta/temperature; UCB: c; GreedyFed:
    averaging/alpha; dropout: + drop_frac)."""
    canon = STRATEGY_ALIASES.get(name, name)
    try:
        accepted = _STRATEGY_KWARGS[canon]
    except KeyError:
        raise ValueError(f"unknown selector {name!r}; "
                         f"options: {strategy_names()}") from None
    bad = sorted(set(kw) - set(accepted))
    if bad:
        raise TypeError(f"selector {name!r} got unexpected kwargs {bad}; "
                        f"accepts {sorted(accepted)}")
    p = {**accepted, **kw}
    spec = SelectorSpec(name=canon, n_clients=n_clients, m=m, d0=n_clients)
    if canon == "power_of_choice":
        d0 = p["d0"]
        spec = spec._replace(decay=float(p["decay"]),
                             d0=int(d0) if d0 is not None else n_clients)
    elif canon == "s_fedavg":
        spec = spec._replace(sv_mode="exponential",
                             sv_alpha=float(p["beta"]),
                             temperature=float(p["temperature"]))
    elif canon == "ucb":
        spec = spec._replace(c=float(p["c"]))
    elif canon in ("greedyfed", "greedyfed_dropout"):
        spec = spec._replace(sv_mode=str(p["averaging"]),
                             sv_alpha=float(p["alpha"]))
        if canon == "greedyfed_dropout":
            spec = spec._replace(drop_frac=float(p["drop_frac"]))
    return spec


def poc_d_schedule(spec: SelectorSpec, rounds: int) -> np.ndarray:
    """(T,) int32 Power-of-Choice candidate counts."""
    return np.asarray(
        [max(spec.m, int(round(spec.d0 * (spec.decay ** t))))
         for t in range(rounds)], np.int32)


# --------------------------------------------------------------------------
# score / probability helpers
# --------------------------------------------------------------------------

def poc_probs(data_fractions: torch.Tensor) -> torch.Tensor:
    """Power-of-Choice candidate-sampling probabilities: normalised q_k."""
    p = data_fractions.to(torch.float32)
    return p / torch.sum(p)


def sfedavg_probs(val: ValuationState, temperature: float) -> torch.Tensor:
    """S-FedAvg selection probabilities: softmax over the EMA value vector
    (unvalued clients get the mean value of valued ones)."""
    init = val.initialised
    n_init = torch.sum(init.to(torch.float32))
    mean_init = (torch.sum(torch.where(init, val.sv, 0.0))
                 / torch.clamp_min(n_init, 1.0))
    sv = torch.where(n_init > 0, torch.where(init, val.sv, mean_init), val.sv)
    z = (sv - torch.max(sv)) / max(temperature, 1e-8)
    p = torch.exp(z)
    return p / torch.sum(p)


def ucb_scores(val: ValuationState, round_t: torch.Tensor,
               c: float) -> torch.Tensor:
    """UCB acquisition: SV_k + c * sqrt(ln t / N_k) (t clipped at 2)."""
    counts = torch.clamp_min(val.counts.to(torch.float32), 1.0)
    t = torch.clamp_min(round_t, 2).to(torch.float32)
    return val.sv + c * torch.sqrt(torch.log(t) / counts)


def _gumbel_order(gumbel: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """(N,) full preference order of a without-replacement draw with
    probabilities p from Gumbel noise (the reference's Gumbel top-k)."""
    g = -gumbel - torch.log(p)
    return torch.argsort(g, stable=True)


def _top_m(scores: torch.Tensor, m: int) -> torch.Tensor:
    """Indices of the m largest scores; ties resolve by client index."""
    return torch.argsort(-scores, stable=True)[:m]


# --------------------------------------------------------------------------
# per-strategy select functions
# --------------------------------------------------------------------------

def _rr_select(spec: SelectorSpec, state: DeviceSelectorState) -> torch.Tensor:
    """Alg. 1 lines 2-3: round-robin through the fixed random order."""
    idx = (state.round * spec.m + torch.arange(
        spec.m, device=state.rr_order.device)) % spec.n_clients
    return state.rr_order[idx]


def _sel_random(spec, state, ctx, draw):
    return draw.choice, state


def _sel_power_of_choice(spec, state, ctx, draw):
    # candidates = the first d of the full Gumbel order
    order = _gumbel_order(draw.gumbel, poc_probs(ctx.data_fractions))
    cand_losses = ctx.local_losses[order]
    in_draw = torch.arange(spec.n_clients, device=order.device) < ctx.poc_d
    masked = torch.where(in_draw, cand_losses, -torch.inf)
    return order[_top_m(masked, spec.m)], state


def _sel_s_fedavg(spec, state, ctx, draw):
    order = _gumbel_order(draw.gumbel,
                          sfedavg_probs(state.valuation, spec.temperature))
    return order[: spec.m], state


def _round_robin_or(spec, state, top):
    """Alg. 1: round-robin for the first ceil(N / M) rounds, then `top`."""
    return torch.where(state.round < spec.rr_rounds,
                       _rr_select(spec, state), top)


def _sel_ucb(spec, state, ctx, draw):
    top = _top_m(ucb_scores(state.valuation, state.round, spec.c), spec.m)
    return _round_robin_or(spec, state, top), state


def _sel_greedyfed(spec, state, ctx, draw):
    return _round_robin_or(spec, state,
                           _top_m(state.valuation.sv, spec.m)), state


def _sel_greedyfed_dropout(spec, state, ctx, draw):
    post_rr = state.round >= spec.rr_rounds
    # freeze the active set at the first post-RR selection: keep the top
    # n_keep by cumulative SV, drop the rest for good
    rank = torch.argsort(-state.valuation.sv, stable=True)
    keep = torch.zeros_like(state.active).scatter(0, rank[: spec.n_keep],
                                                  True)
    active = torch.where(post_rr & ~state.frozen, keep, state.active)
    state = state._replace(active=active, frozen=state.frozen | post_rr)
    sv_masked = torch.where(active, state.valuation.sv, -torch.inf)
    return _round_robin_or(spec, state, _top_m(sv_masked, spec.m)), state


_SELECT_FNS = {
    "random": _sel_random,
    "power_of_choice": _sel_power_of_choice,
    "s_fedavg": _sel_s_fedavg,
    "ucb": _sel_ucb,
    "greedyfed": _sel_greedyfed,
    "greedyfed_dropout": _sel_greedyfed_dropout,
}


def device_select(spec: SelectorSpec, state: DeviceSelectorState,
                  ctx: DeviceSelectionContext, draw: SelectionDraw
                  ) -> tuple[torch.Tensor, DeviceSelectorState]:
    """Select the round's cohort: (sel (m,) int64, new state).  `draw`
    holds the round's selection randomness; only the randomised strategies
    read it."""
    try:
        fn = _SELECT_FNS[spec.name]
    except KeyError:
        raise ValueError(f"unknown selector {spec.name!r}; "
                         f"options: {sorted(_SELECT_FNS)}") from None
    sel, state = fn(spec, state, ctx, draw)
    return sel.to(torch.int64), state


def device_update(spec: SelectorSpec, state: DeviceSelectorState,
                  sel: torch.Tensor, sv_round: Optional[torch.Tensor] = None
                  ) -> DeviceSelectorState:
    """Post-round bookkeeping: value the cohort (strategies that use SV)
    or only bump its selection counts, then advance the round."""
    val = state.valuation
    sel = sel.to(torch.int64)
    if sv_round is not None and spec.uses_shapley:
        val = update_valuation(val, sel, sv_round, mode=spec.sv_mode,
                               alpha=spec.sv_alpha)
    else:
        val = ValuationState(sv=val.sv, counts=bump_counts(val.counts, sel),
                             initialised=val.initialised.index_fill(
                                 0, sel, True))
    return state._replace(valuation=val, round=state.round + 1)


@functools.lru_cache(maxsize=64)
def jitted_selector(spec: SelectorSpec):
    """The `(select, update)` pair for one spec, cached process-wide (the
    reference's compiled pair; the port compiles nothing, and a captured
    round holds the calls)."""
    return (functools.partial(device_select, spec),
            functools.partial(device_update, spec))


def _where_state(pick: torch.Tensor, a, b):
    """`a` where `pick`, else `b`, leaf by leaf over (nested) tuples of
    tensors."""
    if isinstance(a, tuple):
        parts = [_where_state(pick, x, y) for x, y in zip(a, b)]
        return type(a)(*parts) if hasattr(a, "_fields") else tuple(parts)
    return torch.where(pick, a, b)


def _switch(specs: tuple, strategy_id: torch.Tensor, outs: list):
    """The branch `strategy_id` of every branch's output: each branch runs,
    and a device select keeps one, so no host reads the id."""
    out = outs[-1]
    for i in range(len(specs) - 2, -1, -1):
        out = _where_state(strategy_id == i, outs[i], out)
    return out


def device_select_any(specs: tuple[SelectorSpec, ...],
                      strategy_id: torch.Tensor,
                      state: DeviceSelectorState,
                      ctx: DeviceSelectionContext, draw: SelectionDraw
                      ) -> tuple[torch.Tensor, DeviceSelectorState]:
    """Select by the strategy `strategy_id` (a () device tensor) of a
    static tuple of specs, which must share (n_clients, m); one branch
    when the tuple has one spec.  `draw` must hold what every branch
    reads."""
    if len(specs) == 1:
        return device_select(specs[0], state, ctx, draw)
    return _switch(specs, strategy_id,
                   [device_select(sp, state, ctx, draw) for sp in specs])


def device_update_any(specs: tuple[SelectorSpec, ...],
                      strategy_id: torch.Tensor, state: DeviceSelectorState,
                      sel: torch.Tensor,
                      sv_round: Optional[torch.Tensor] = None
                      ) -> DeviceSelectorState:
    if len(specs) == 1:
        return device_update(specs[0], state, sel, sv_round)
    return _switch(specs, strategy_id,
                   [device_update(sp, state, sel, sv_round) for sp in specs])


def device_dropped_fraction(state: DeviceSelectorState) -> torch.Tensor:
    """Fraction of clients dropped from the protocol (0 until frozen)."""
    return torch.where(state.frozen,
                       1.0 - torch.mean(state.active.to(torch.float32)),
                       0.0)


def gather_client_state(state: DeviceSelectorState, axis, n_clients: int,
                        extra: Sequence[torch.Tensor] = ()):
    """Client-sharded selector state -> (full state, put_back, extra full).

    Under client sharding every per-client leaf of `state` (sv, counts,
    initialised, rr_order, active) is this rank's (N_pad / shards,) block;
    the scalars (round, frozen) are the same on every rank.  Selection is
    a global top-m, so the strategies run on the exact (N,) state:

        full, put_back, (losses,) = gather_client_state(
            state, group, n, (local_losses,))
        sel, full = device_select_any(specs, sid, full, ctx, draw)
        state = put_back(device_update_any(specs, sid, full, sel, sv))

    The blocks, and the (n_local,) tensors `extra` beside them (the
    Power-of-Choice losses), are packed into one int32 buffer (bool as
    uint8, each padded to 16 bytes) and all-gathered in ONE collective
    over the client group `axis` (`launch.mesh.client_group`); each comes
    back as its (N,) form.  `put_back` re-pads the updated (N,) leaves with
    the gathered pad rows, which keep their initial values, and slices this
    rank's block back out.  Every leaf round-trips bitwise: the gather and
    the slices copy bits, and no strategy reads or writes a pad row."""
    from repro_torch.launch.mesh import (
        all_gather_words, client_group, group_rank, pack_words,
        unpack_blocks,
    )
    group = client_group(axis)
    index = group_rank(group)[0]
    val = state.valuation
    blocks = [val.sv, val.counts, val.initialised, state.rr_order,
              state.active, *extra]
    n_local = blocks[0].shape[0]
    padded = unpack_blocks(all_gather_words(pack_words(blocks), group),
                           blocks)
    exact = [x[:n_clients] for x in padded]
    sv, counts, initialised, rr_order, active = exact[:5]
    full = state._replace(
        valuation=ValuationState(sv=sv, counts=counts,
                                 initialised=initialised),
        rr_order=rr_order, active=active)
    lo = index * n_local

    def put_back(new: DeviceSelectorState) -> DeviceSelectorState:
        def block(pad, x):
            return torch.cat([x, pad[n_clients:]])[lo:lo + n_local]
        nv = new.valuation
        return new._replace(
            valuation=ValuationState(
                sv=block(padded[0], nv.sv), counts=block(padded[1],
                                                         nv.counts),
                initialised=block(padded[2], nv.initialised)),
            rr_order=block(padded[3], new.rr_order),
            active=block(padded[4], new.active))

    return full, put_back, exact[5:]
