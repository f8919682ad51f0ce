"""Multi-seed / multi-strategy replication (counterpart of
`repro/engine/replicated.py`).

Every benchmark table re-runs each (strategy, knob) cell across seeds.

  * `run_replicated`: S seeds of one config on the batched engine, one
    solo `run_federated(engine="batched")` run a seed, each with its own
    dispatch count, round times and `compile_time_s` (its CompileTimer:
    the kernels' build, if that run triggered it), each streaming its own
    `kind="solo"` run into a shared telemetry sink.  The reference vmaps one fused round
    over a seed axis; fusing the port's replicas into wider launches is
    still to come (ROADMAP.md).
  * `run_replicated_scan`: seeds x strategies as one grid,
    `repro_torch.grid.run_grid` (each partition's replicas in one
    captured round graph; each cell bitwise its solo scan run).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence


def run_replicated(cfg, seeds, data=None, model=None, *, device=None,
                   draws: Optional[Sequence] = None, telemetry=None):
    """See `federated.server.run_federated_replicated` (the public alias).
    `draws` gives one `RunDraws` source per seed (None: each seed's
    default); `telemetry` receives every seed's run."""
    from repro_torch.federated.server import run_federated

    seeds = list(seeds)
    if not seeds:
        raise ValueError("run_federated_replicated needs at least one seed")
    draws = list(draws) if draws is not None else [None] * len(seeds)
    if len(draws) != len(seeds):
        raise ValueError(f"got {len(draws)} draw sources for {len(seeds)} "
                         "seeds")
    return [run_federated(dataclasses.replace(cfg, seed=s, engine="batched"),
                          data, model, device=device, draws=d,
                          telemetry=telemetry)
            for s, d in zip(seeds, draws)]


def run_replicated_scan(cfg, seeds, selectors: Optional[Sequence[str]] = None,
                        data=None, model=None, **grid_kwargs):
    """Seeds x strategies, each a full T-round scan run, as one grid
    (`repro_torch.grid.run_grid`): `selectors=None` replicates
    `cfg.selector` across `seeds`.  `grid_kwargs` (rounds_per_segment,
    checkpoint_dir, device, ...) pass through to `run_grid`.

    Returns a flat list of FLResults in (selector-major, seed-minor)
    order."""
    from repro_torch.grid import GridSpec, run_grid

    seeds = list(seeds)
    if not seeds:
        raise ValueError("run_replicated_scan needs at least one seed")
    gspec = GridSpec.product(cfg, selectors=selectors, seeds=seeds)
    return run_grid(gspec, data=data, model=model, **grid_kwargs).results
