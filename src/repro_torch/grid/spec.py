"""GridSpec/GridResult — the declarative experiment-grid API (counterpart
of `repro/grid/spec.py`, numpy only, copied).

A grid is a tuple of `(strategy, seed, knob-overrides)` cells over one
base FLConfig.  Cells may vary anything that is a per-replica operand of
the captured round (seed, selector, selector kwargs, Dirichlet alpha,
straggler fraction, privacy sigma, timing schedule, the eval cadence
`eval_every`); what shapes the round itself (sizes, round budget, client
config, Shapley settings, faults) must be uniform, and `validate()`
rejects mixed values with a precise error before anything runs.
`upload_codec` shapes the round too, but instead of being rejected it
joins the partition key: cells with different codecs land in different
partitions, each captured on its own, so a selection x compression sweep
is one `run_grid` call.  `repro_torch.grid.runner.run_grid` is the
executor.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional, Sequence

import numpy as np

# FLConfig fields that shape a partition's captured round: every cell of a
# grid must agree on them.  `upload_codec` is deliberately absent: it is
# partition-varying (repro_torch.grid.partition groups cells by codec).
STATIC_FIELDS = (
    "dataset", "n_clients", "m", "rounds", "client",
    "n_train", "n_val", "n_test",
    "shapley_eps", "shapley_max_iters", "shapley_impl", "sv_chunk",
    "clients_shards",
    "faults", "quarantine", "quarantine_z",
)


def _freeze_overrides(ov) -> tuple:
    if ov is None:
        return ()
    items = ov.items() if isinstance(ov, Mapping) else tuple(ov)
    return tuple(sorted((str(k), v) for k, v in items))


@dataclasses.dataclass(frozen=True)
class GridCell:
    """One grid cell: a strategy at a seed, plus FLConfig knob overrides."""
    selector: str
    seed: int
    overrides: Any = ()          # mapping | items; frozen to sorted items

    def __post_init__(self):
        object.__setattr__(self, "overrides",
                           _freeze_overrides(self.overrides))

    def config(self, base):
        """The cell's concrete FLConfig (engine pinned to 'scan')."""
        kw = dict(self.overrides)
        kw.update(selector=self.selector, seed=self.seed, engine="scan")
        return dataclasses.replace(base, **kw)


@dataclasses.dataclass(frozen=True)
class GridSpec:
    """A declarative grid: base FLConfig + cells, validated before a run."""
    base: Any                    # FLConfig
    cells: tuple                 # tuple[GridCell, ...]

    def __post_init__(self):
        object.__setattr__(self, "cells", tuple(self.cells))
        if not self.cells:
            raise ValueError("GridSpec needs at least one cell")

    @staticmethod
    def product(base, selectors: Optional[Sequence[str]] = None,
                seeds: Sequence[int] = (0,),
                overrides=None) -> "GridSpec":
        """The benchmark-table grid: selectors x seeds (selector-major,
        seed-minor, the `run_replicated_scan` result order), with one
        shared overrides mapping applied to every cell."""
        names = list(selectors) if selectors else [base.selector]
        seeds = list(seeds)
        if not seeds:
            raise ValueError("GridSpec.product needs at least one seed")
        return GridSpec(base, tuple(
            GridCell(name, seed, overrides)
            for name in names for seed in seeds))

    def cell_configs(self) -> list:
        return [cell.config(self.base) for cell in self.cells]

    def validate(self) -> list:
        """Check grid-wide static uniformity; returns the cell FLConfigs."""
        from repro_torch.federated.compression import CODECS

        cfgs = self.cell_configs()
        for i, cfg in enumerate(cfgs):
            for f in STATIC_FIELDS:
                if getattr(cfg, f) != getattr(self.base, f):
                    raise ValueError(
                        f"grid cells must agree on the static FLConfig "
                        f"field {f!r}: cell {i} has {getattr(cfg, f)!r}, "
                        f"base has {getattr(self.base, f)!r}")
            if cfg.upload_codec not in CODECS:
                raise ValueError(
                    f"cell {i} has unknown upload_codec "
                    f"{cfg.upload_codec!r}; known: {sorted(CODECS)}")
        return cfgs


@dataclasses.dataclass(frozen=True)
class CellFailure:
    """Degraded grid entry: the cell's partition raised instead of
    producing an FLResult.  Carries the error payload for triage; the
    numeric class attributes keep naive aggregations (mean accuracy, byte
    totals) well-defined: NaN accuracy drops out of mean/filters, zero
    bytes add nothing."""
    cell: int                    # index into GridSpec.cells
    selector: str
    seed: int
    partition: str               # PartitionKey.label of the failed partition
    error: str                   # repr() of the raised exception
    traceback: str
    final_acc: float = float("nan")
    shapley_evals: int = 0
    upload_bytes: int = 0
    download_bytes: int = 0


@dataclasses.dataclass
class GridResult:
    """Grid outputs in cell order, plus execution-shape bookkeeping."""
    spec: GridSpec
    results: list                # FLResult | CellFailure per cell
    partitions: list             # repro_torch.grid.partition.PartitionReport
    rounds_per_segment: int
    n_segments: int
    wall_time_s: float

    def cell(self, selector: str, seed: int):
        """The FLResult of one (selector, seed) cell (first match)."""
        for c, r in zip(self.spec.cells, self.results):
            if c.selector == selector and c.seed == seed:
                return r
        raise KeyError(f"no grid cell ({selector!r}, seed={seed})")

    def select(self, selector: str) -> list:
        return [r for c, r in zip(self.spec.cells, self.results)
                if c.selector == selector]

    def acc_summary(self) -> dict:
        """selector -> (mean, std) of final accuracy across its surviving
        cells (CellFailure entries are excluded)."""
        out: dict = {}
        for c, r in zip(self.spec.cells, self.results):
            if isinstance(r, CellFailure):
                continue
            out.setdefault(c.selector, []).append(r.final_acc)
        return {k: (float(np.mean(v)), float(np.std(v)))
                for k, v in out.items()}

    @property
    def failures(self) -> list:
        """The grid's CellFailure entries (empty on a clean run)."""
        return [r for r in self.results if isinstance(r, CellFailure)]

    @property
    def dispatches(self) -> int:
        return sum(p.dispatches for p in self.partitions)
