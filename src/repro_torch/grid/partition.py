"""Partitioned dispatch: group grid cells by execution capability
(counterpart of `repro/grid/partition.py`, copied over the port's
`SelectorSpec`).

Cells are grouped by `(uses_shapley, uses_local_losses, upload_codec)`:
each group runs its own captured round, which only holds the stages the
group needs (the codec is static inside the round body, so a mixed-codec
grid needs one round per codec), and per-group results are re-interleaved
into grid order.  So the FedAvg cells of a benchmark table do not pay the
GTG-Shapley stage, and a selection x compression sweep is one `run_grid`
call with at most `capability-classes x codecs` captures.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

from repro_torch.core.selection import SelectorSpec


class PartitionKey(NamedTuple):
    needs_sv: bool
    uses_local_losses: bool
    upload_codec: str = "identity"

    @property
    def label(self) -> str:
        base = ("sv" if self.needs_sv
                else "losses" if self.uses_local_losses else "plain")
        # identity keeps the bare capability label (and the checkpoint
        # tags); compressed partitions append their codec
        if self.upload_codec == "identity":
            return base
        return f"{base}+{self.upload_codec}"


class Partition(NamedTuple):
    """One capability group of a grid."""
    key: PartitionKey
    cell_indices: tuple          # positions in the grid's flat cell order
    specs: tuple                 # deduped SelectorSpecs (the switch table)
    strategy_ids: tuple          # per replica: index into `specs`


class PartitionReport(NamedTuple):
    """Host-side execution evidence per partition."""
    label: str
    cell_indices: tuple
    needs_sv: bool
    uses_local_losses: bool
    n_strategies: int
    dispatches: int              # segments run by this call (resume: fewer)
    shapley_evals: int           # total utility evals across the partition
    bytes_resident: int          # the replicas' operand + carry bytes
    flops_per_dispatch: float = float("nan")   # not measured by the port
    peak_bytes: Optional[int] = None
    upload_codec: str = "identity"
    # the port's own: graph replays made by this call ({"round": n,
    # "eval": n}), the kernel launches each captured graph holds (None
    # when nothing was captured), the replays' device time a round
    # (CUDA events; the host clock on the CPU), the capture (warm-up
    # included) and the host's draw staging
    replays: Optional[dict] = None
    graph_launches: Optional[dict] = None
    round_time_s: float = float("nan")
    capture_time_s: float = 0.0
    stage_time_s: float = 0.0


def partition_key(spec: SelectorSpec,
                  upload_codec: str = "identity") -> PartitionKey:
    return PartitionKey(bool(spec.uses_shapley),
                        bool(spec.uses_local_losses),
                        str(upload_codec))


def partition_cells(specs: Sequence[SelectorSpec],
                    upload_codecs: Optional[Sequence[str]] = None) -> list:
    """Group cell selector-specs into Partitions (stable order: first
    appearance of each capability class; cells keep grid order within).

    `upload_codecs` gives each cell's codec (default: all identity); cells
    only share a partition when both the capability pair and the codec
    agree.  Identical SelectorSpecs share one switch branch, so a partition
    of R seeds x one strategy selects statically (len(specs) == 1)."""
    if upload_codecs is None:
        upload_codecs = ["identity"] * len(specs)
    if len(upload_codecs) != len(specs):
        raise ValueError(f"got {len(upload_codecs)} upload_codecs for "
                         f"{len(specs)} cells")
    groups: dict = {}
    order: list = []
    for i, spec in enumerate(specs):
        k = partition_key(spec, upload_codecs[i])
        if k not in groups:
            groups[k] = []
            order.append(k)
        groups[k].append((i, spec))
    parts = []
    for k in order:
        uniq: list = []
        sids = []
        for _, spec in groups[k]:
            if spec not in uniq:
                uniq.append(spec)
            sids.append(uniq.index(spec))
        parts.append(Partition(
            key=k,
            cell_indices=tuple(i for i, _ in groups[k]),
            specs=tuple(uniq),
            strategy_ids=tuple(sids)))
    return parts


def interleave(n_cells: int, partitions: Sequence[Partition],
               per_partition: Sequence[list]) -> list:
    """Scatter per-partition result lists back into grid cell order."""
    out = [None] * n_cells
    for part, results in zip(partitions, per_partition):
        if len(part.cell_indices) != len(results):
            raise ValueError(
                f"partition {part.key.label!r} returned {len(results)} "
                f"results for {len(part.cell_indices)} cells")
        for idx, res in zip(part.cell_indices, results):
            out[idx] = res
    missing = [i for i, r in enumerate(out) if r is None]
    if missing:
        raise ValueError(f"grid cells {missing} were not covered by any "
                         "partition")
    return out
