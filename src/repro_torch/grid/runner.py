"""run_grid — the experiment-grid executor (counterpart of
`repro/grid/runner.py`).

Pipeline: validate the GridSpec -> set up every cell (the same draws and
numpy streams as a solo run at that cell's config) -> partition cells by
capability and codec -> per partition, build each replica's solo scan
operands and drive the segmented replica step (one captured round graph
for the partition's S replicas) -> rebuild per-cell FLResults with
`scan_engine.results_from_scan` and re-interleave them into grid order.
Every cell equals its solo `run_federated(engine="scan")` bit for bit.
"""
from __future__ import annotations

import hashlib
import json
import os
import time
import traceback
from typing import Optional, Sequence

import torch

from repro_torch.engine.round_engine import SegmentCarry, round_plan
from repro_torch.engine.scan_engine import (
    make_scan_spec, results_from_scan, scan_operands,
)
from repro_torch.grid.partition import (
    Partition, PartitionReport, interleave, partition_cells,
)
from repro_torch.grid.segments import ReplicaBatch, run_segments, segment_plan
from repro_torch.grid.spec import CellFailure, GridResult, GridSpec

PACKAGE = "repro_torch"

# Revision of the port's segment-snapshot layout (per replica: the
# SegmentCarry, the segment's outputs and its draw source's state; the
# replay time a round): bump whenever it changes, so a stale checkpoint
# directory fails with a version-skew error instead of an opaque structure
# mismatch.  The reference's directories carry its own formats (1-4) and
# no package name, and are refused.
CARRY_FORMAT = 1

# Revision of the cell -> partition assignment rule (the reference's):
# segment snapshots are tagged by partition index ("p0-seg0000.npz"), so a
# partitioning change would restore the wrong cells' state.
# 1 = capability pair; 2 = capability pair x upload_codec.
PARTITION_REV = 2


def _not_in_slice(what: str, slice_: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet: it comes with {slice_} of the PyTorch "
        "port (see ROADMAP.md)")


def _check_fingerprint(checkpoint_dir: str, spec: GridSpec,
                       rounds_per_segment: int, resume: bool) -> None:
    """Refuse to resume another grid's checkpoints, or another package's
    or layout's: segment snapshots are only told apart by their shapes, so
    a config change that keeps shapes (seeds, knobs, a same-capability
    selector swap) would otherwise restore the previous experiment."""
    fp = hashlib.sha256(repr(
        (spec.base, spec.cells, rounds_per_segment,
         PARTITION_REV)).encode()).hexdigest()
    path = os.path.join(checkpoint_dir, "grid.json")
    if os.path.exists(path):
        with open(path) as f:
            saved = json.load(f)
        fmt = (saved.get("package", "repro"), saved.get("carry_format", 1))
        if resume and fmt != (PACKAGE, CARRY_FORMAT):
            raise ValueError(
                f"checkpoint_dir {checkpoint_dir!r} holds segments in carry "
                f"format {fmt[1]} of package {fmt[0]!r} but this version "
                f"writes format {CARRY_FORMAT} of {PACKAGE!r}; the snapshots "
                "cannot be resumed — point the run at a fresh directory")
        if resume and saved.get("fingerprint") != fp:
            raise ValueError(
                f"checkpoint_dir {checkpoint_dir!r} holds segments of a "
                "DIFFERENT grid (config fingerprint mismatch); point the "
                "run at a fresh directory or pass resume=False to "
                "overwrite")
    os.makedirs(checkpoint_dir, exist_ok=True)
    with open(path, "w") as f:
        json.dump({"package": PACKAGE, "fingerprint": fp,
                   "carry_format": CARRY_FORMAT}, f)


def _build_batch(part: Partition, cfgs, setups, rounds_per_segment: int):
    """The partition's ScanSpec and its replicas: each its solo run's
    operands and draw plan, with its strategy's index into the
    partition's selector tuple."""
    cfg0 = cfgs[part.cell_indices[0]]
    spec = make_scan_spec(cfg0, part.specs,
                          rounds_per_segment=rounds_per_segment)
    ops, plans, carries = [], [], []
    for idx, sid in zip(part.cell_indices, part.strategy_ids):
        cfg, s = cfgs[idx], setups[idx]
        device = s.n_valid.device
        ops.append(scan_operands(cfg, s)._replace(strategy_id=torch.tensor(
            sid, dtype=torch.int64, device=device)))
        plans.append(round_plan(spec.round, cfg.client, (s.sel_spec,),
                                cfg.n_clients, cfg.m, s.params,
                                s.n_valid.cpu().numpy()))
        carries.append(SegmentCarry(s.params, s.sel_state, torch.zeros(
            (), dtype=torch.int64, device=device)))
    batch = ReplicaBatch(
        cfgs=tuple(cfgs[i] for i in part.cell_indices),
        setups=tuple(setups[i] for i in part.cell_indices),
        ops=tuple(ops), plans=tuple(plans), carries=tuple(carries))
    return spec, batch


def _per_cell(values, n: int, what: str) -> list:
    """One dataset / draw source for every cell, or a list with one each
    (a SynthDataset is a NamedTuple, hence a tuple: `_fields` tells)."""
    if isinstance(values, (list, tuple)) and not hasattr(values, "_fields"):
        if len(values) != n:
            raise ValueError(f"got {len(values)} {what} for {n} grid cells")
        return list(values)
    return [values] * n


def run_grid(spec: GridSpec, *, data=None, model=None,
             rounds_per_segment: int = 0,
             checkpoint_dir: Optional[str] = None, resume: bool = True,
             shard: bool = True, max_segments: Optional[int] = None,
             compile_stats: bool = False, telemetry=None,
             isolate_cells: bool = True, retries: int = 0,
             retry_backoff_s: float = 0.05, device=None,
             draws: Optional[Sequence] = None) -> Optional[GridResult]:
    """Execute a grid on `device` (default: the CUDA card).  Returns None
    if `max_segments` stopped the run before completion (the checkpoints on
    disk are the resume point).

    * `rounds_per_segment=K` runs T/K segments of K rounds, reading the
      outputs back at each boundary; bit for bit the unsegmented grid.
    * `checkpoint_dir` snapshots each segment; with `resume=True` a rerun
      restores the checkpointed prefix and only runs what is missing.
    * `isolate_cells=True`: a partition that raises (its capture, a replay
      or a read-back) comes back as one `CellFailure` a cell, and the other
      partitions complete; spec validation, the segment plan and the
      checkpoint fingerprint still raise up front.  `retries` /
      `retry_backoff_s` pass to `run_segments`.
    * `data` may be one dataset (shared by every cell) or one per cell;
      `draws` one `RunDraws` source per cell (None: each cell's default,
      the solo run's `TorchDraws`).
    * `shard=True` on one device is the plain path.  Telemetry,
      `compile_stats` and `clients_shards > 1` come with later slices.
    """
    if telemetry is not None:
        raise _not_in_slice("run_grid(telemetry=...)", "the telemetry slice")
    if compile_stats:
        raise _not_in_slice("run_grid(compile_stats=True)",
                            "the telemetry slice")
    t_start = time.perf_counter()
    cfgs = spec.validate()
    segment_plan(spec.base.rounds, rounds_per_segment)  # fail fast
    if spec.base.clients_shards > 1:
        raise _not_in_slice("clients_shards > 1", "the client-sharding slice")
    from repro_torch.federated.server import setup_run

    cell_data = _per_cell(data, len(cfgs), "datasets")
    cell_draws = _per_cell(draws, len(cfgs), "draw sources")
    setups = [setup_run(c, d, model, device=device, draws=dr)
              for c, d, dr in zip(cfgs, cell_data, cell_draws)]
    model = setups[0].model
    partitions = partition_cells([s.sel_spec for s in setups],
                                 [c.upload_codec for c in cfgs])
    if checkpoint_dir:
        _check_fingerprint(checkpoint_dir, spec, rounds_per_segment, resume)

    per_partition, reports = [], []
    n_segments = segment_plan(spec.base.rounds, rounds_per_segment)[1]
    for pi, part in enumerate(partitions):
        t_part = time.perf_counter()
        key = part.key
        try:
            scan_spec, batch = _build_batch(part, cfgs, setups,
                                            rounds_per_segment)
            outs, rep = run_segments(
                model, cfgs[part.cell_indices[0]].client, scan_spec, batch,
                checkpoint_dir=checkpoint_dir, tag=f"p{pi}-", resume=resume,
                max_segments=max_segments, retries=retries,
                retry_backoff_s=retry_backoff_s)
            if outs is None:
                return None
            # the partition's cells ran together: they share its duration
            wall = time.perf_counter() - t_part
            results = [results_from_scan(
                cfgs[idx], setups[idx], out, wall_time_s=wall,
                dispatches=sum(rep.replays.values()),
                uses_shapley=key.needs_sv,
                compile_time_s=rep.compile_time_s,
                round_time_s=rep.round_time_s,
                stage_time_s=rep.stage_time_s,
                graph_launches=rep.graph_launches)
                for idx, out in zip(part.cell_indices, outs)]
            per_partition.append(results)
            reports.append(PartitionReport(
                label=key.label, cell_indices=part.cell_indices,
                needs_sv=key.needs_sv,
                uses_local_losses=key.uses_local_losses,
                n_strategies=len(part.specs), dispatches=rep.dispatches,
                shapley_evals=sum(r.shapley_evals for r in results),
                bytes_resident=rep.bytes_resident,
                upload_codec=key.upload_codec, replays=rep.replays,
                graph_launches=rep.graph_launches,
                round_time_s=(sum(rep.round_time_s) / len(rep.round_time_s)
                              if rep.round_time_s else float("nan")),
                capture_time_s=rep.compile_time_s,
                stage_time_s=rep.stage_time_s))
        except Exception as e:
            # cell isolation: a raising partition degrades to per-cell
            # CellFailure entries; KeyboardInterrupt still aborts
            if not isolate_cells:
                raise
            tb = traceback.format_exc()
            per_partition.append([CellFailure(
                cell=idx, selector=cfgs[idx].selector, seed=cfgs[idx].seed,
                partition=key.label, error=repr(e), traceback=tb)
                for idx in part.cell_indices])
            reports.append(PartitionReport(
                label=key.label, cell_indices=part.cell_indices,
                needs_sv=key.needs_sv,
                uses_local_losses=key.uses_local_losses,
                n_strategies=len(part.specs), dispatches=0,
                shapley_evals=0, bytes_resident=0,
                upload_codec=key.upload_codec))
    return GridResult(
        spec=spec,
        results=interleave(len(spec.cells), partitions, per_partition),
        partitions=reports, rounds_per_segment=rounds_per_segment,
        n_segments=n_segments, wall_time_s=time.perf_counter() - t_start)
