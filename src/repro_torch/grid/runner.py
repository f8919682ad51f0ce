"""run_grid — the experiment-grid executor (counterpart of
`repro/grid/runner.py`).

Pipeline: validate the GridSpec -> partition cells by capability and
codec -> per partition, set up its cells (the same draws and numpy
streams as a solo run at that cell's config), build each replica's solo
scan operands and drive the segmented replica step (one captured round
graph for the partition's S replicas) -> rebuild per-cell FLResults with
`scan_engine.results_from_scan` and re-interleave them into grid order.
Every cell equals its solo `run_federated(engine="scan")` bit for bit.
In a world of several ranks a partition runs on its run mesh
(`grid/shard.py`): replica rows, each of whole replicas, and with
`clients_shards > 1` client blocks within a row; each rank sets up and
runs only its replicas and block, and the rows' results reach every rank
on the host after the partition.
A telemetry sink streams the grid as the reference's does (`run_start`
kind "grid", the segments' events, per-cell `round_metrics` / `eval` at
each partition's end, `cell_failed`, `compile` with the heaviest
partition's cost card, `run_end`); it stays out of `GridSpec`, so the
checkpoint fingerprint does not see it.
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
from repro_torch.engine.schedule import eval_mask
from repro_torch.federated.compression import codec_nbytes
from repro_torch.telemetry.events import provenance
from repro_torch.telemetry.metrics import emit_scan_rounds, run_end_payload
from repro_torch.telemetry.profile import trace_capture
from repro_torch.grid.partition import (
    Partition, PartitionReport, interleave, partition_cells,
)
from repro_torch.grid.segments import ReplicaBatch, run_segments, segment_plan
from repro_torch.grid.spec import CellFailure, GridResult, GridSpec
from repro_torch.tree import tree_leaves

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


def _check_fingerprint(checkpoint_dir: str, spec: GridSpec,
                       rounds_per_segment: int, resume: bool,
                       world_size: int = 1) -> None:
    """Refuse to resume another grid's checkpoints, or another package's
    or layout's: segment snapshots are only told apart by their shapes, so
    a config change that keeps shapes (seeds, knobs, a same-capability
    selector swap) would otherwise restore the previous experiment.  In a
    world of several ranks the fingerprint holds its size (each rank's
    files hold its replicas and client blocks), every rank checks it
    before rank 0 writes it, and all wait for the write."""
    key = (spec.base, spec.cells, rounds_per_segment, PARTITION_REV)
    if world_size > 1:
        key += (("world", world_size),)
    fp = hashlib.sha256(repr(key).encode()).hexdigest()
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
    if world_size > 1:
        import torch.distributed as dist
        dist.barrier()
        if dist.get_rank() != 0:
            dist.barrier()
            return
    os.makedirs(checkpoint_dir, exist_ok=True)
    with open(path, "w") as f:
        json.dump({"package": PACKAGE, "fingerprint": fp,
                   "carry_format": CARRY_FORMAT}, f)
    if world_size > 1:
        dist.barrier()


def _build_batch(part: Partition, cfgs, setups, rounds_per_segment: int,
                 live_tap: bool = False):
    """The partition's ScanSpec and its replicas: each its solo run's
    operands and draw plan, with its strategy's index into the
    partition's selector tuple."""
    cfg0 = cfgs[part.cell_indices[0]]
    spec = make_scan_spec(cfg0, part.specs,
                          rounds_per_segment=rounds_per_segment,
                          live_tap=live_tap)
    ops, plans, carries = [], [], []
    for idx, sid in zip(part.cell_indices, part.strategy_ids):
        cfg, s = cfgs[idx], setups[idx]
        device = s.n_valid.device
        ops.append(scan_operands(cfg, s)._replace(strategy_id=torch.tensor(
            sid, dtype=torch.int64, device=device)))
        plans.append(round_plan(spec.round, cfg.client, (s.sel_spec,),
                                cfg.n_clients, cfg.m, s.params,
                                s.valid_counts))
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


def _merge_reports(part: Partition, reports: list) -> PartitionReport:
    """One partition's report from its replica rows' (every row ran the
    same segments): the whole partition's cells, its rows' Shapley
    evaluations and resident bytes summed."""
    first = reports[0]
    return first._replace(
        cell_indices=part.cell_indices,
        shapley_evals=sum(r.shapley_evals for r in reports),
        bytes_resident=sum(r.bytes_resident for r in reports))


def run_grid(spec: GridSpec, *, data=None, model=None,
             rounds_per_segment: int = 0,
             checkpoint_dir: Optional[str] = None, resume: bool = True,
             shard: bool = True, max_segments: Optional[int] = None,
             compile_stats: bool = False, telemetry=None,
             isolate_cells: bool = True, retries: int = 0,
             retry_backoff_s: float = 0.05, device=None,
             draws: Optional[Sequence] = None) -> Optional[GridResult]:
    """Execute a grid on `device` (default: the CUDA card; this rank's card
    in a world of several ranks).  Returns None if `max_segments` stopped
    the run before completion (the checkpoints on disk are the resume
    point).

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
    * `shard=True` spreads each partition over the ranks of the world
      (SPMD: every rank calls `run_grid`): on the run mesh of its replicas
      (`launch.mesh.make_run_mesh`) each replica row runs whole replicas,
      and with `clients_shards > 1` each rank of a row holds one client
      block of them, as `run_federated` does.  Every rank sets up only its
      own cells; the rows' results are gathered to every rank on the host
      after each partition, never inside a round.  On a world of one rank
      it is the plain path.  `clients_shards > 1` needs `shard=True`.
      A checkpoint holds one rank's replicas and blocks: each rank writes
      its own files (tag `p{i}-r{row}c{block}-`), and the fingerprint holds
      the world's size, so a rerun must use the same world.
    * `telemetry` (default None: nothing added) streams the grid, from
      rank 0 only; `compile_stats=True` (or a sink) fills each partition
      report's cost card, `flops_per_dispatch` and, on a card,
      `peak_bytes`.
    """
    from repro_torch.federated.server import selector_spec, setup_run
    from repro_torch.grid.shard import (
        make_run_mesh, pad_batch_clients, position, share_results,
    )
    from repro_torch.launch.mesh import init_world, rank_device, world
    from repro_torch.models.mlp_cnn import make_classifier

    t_start = time.perf_counter()
    cfgs = spec.validate()
    segment_plan(spec.base.rounds, rounds_per_segment)  # fail fast
    shards = spec.base.clients_shards
    if shards > 1 and not shard:
        raise ValueError("clients_shards > 1 requires shard=True (the "
                         "client axis is a mesh axis)")
    init_world()
    rank, size = world()
    if rank != 0:
        telemetry = None
    if device is None and size > 1 and torch.cuda.is_available():
        device = rank_device()
    if model is None:
        model = make_classifier(spec.base.dataset)

    cell_data = _per_cell(data, len(cfgs), "datasets")
    cell_draws = _per_cell(draws, len(cfgs), "draw sources")
    setups: dict = {}

    def set_up(idx: int, block=None):
        setups[idx] = setup_run(cfgs[idx], cell_data[idx], model,
                                device=device, draws=cell_draws[idx],
                                shard=block)

    partitions = partition_cells([selector_spec(c) for c in cfgs],
                                 [c.upload_codec for c in cfgs])
    if checkpoint_dir:
        _check_fingerprint(checkpoint_dir, spec, rounds_per_segment, resume,
                           world_size=size)
    if telemetry is not None:
        telemetry.emit(
            "run_start", run_id=telemetry.run_id, kind="grid",
            cells=len(cfgs), partitions=len(partitions),
            rounds=spec.base.rounds, rounds_per_segment=rounds_per_segment,
            checkpoint_dir=checkpoint_dir, provenance=provenance())

    per_partition, reports = [], []
    n_segments = segment_plan(spec.base.rounds, rounds_per_segment)[1]
    live = bool(telemetry is not None and telemetry.live_tap)
    compile_s, cards = 0.0, []
    with trace_capture(telemetry, label="grid"):
        for pi, part in enumerate(partitions):
            t_part = time.perf_counter()
            key = part.key
            mesh = (make_run_mesh(len(part.cell_indices), shards)
                    if shard and (size > 1 or shards > 1) else None)
            row, block, client_shard = 0, 0, None
            if mesh is None:
                mine, tag = part, f"p{pi}-" + (f"w{rank}-" if size > 1
                                               else "")
            elif position(mesh) is None:
                mine, tag = None, ""          # a rank outside the mesh
            else:
                row, block, rows, blocks = position(mesh)
                # whole replicas a row, in order
                per = len(part.cell_indices) // rows
                keep = range(row * per, (row + 1) * per)
                mine = part._replace(
                    cell_indices=tuple(part.cell_indices[i] for i in keep),
                    strategy_ids=tuple(part.strategy_ids[i] for i in keep))
                tag = f"p{pi}-r{row}c{block}-"
                if blocks > 1:
                    client_shard = (block, blocks)
            local: dict = {}
            try:
                if mine is not None:
                    for idx in mine.cell_indices:
                        set_up(idx, client_shard)
                    scan_spec, batch = _build_batch(
                        mine, cfgs, setups, rounds_per_segment, live)
                    if client_shard is not None:
                        batch = pad_batch_clients(batch, client_shard[1],
                                                  client_shard[0])
                    if telemetry is not None:
                        telemetry.heartbeat(
                            f"partition {pi + 1}/{len(partitions)} "
                            f"({key.label}, {len(part.cell_indices)} cells)",
                            force=True)
                    outs, rep = run_segments(
                        model, cfgs[mine.cell_indices[0]].client, scan_spec,
                        batch, checkpoint_dir=checkpoint_dir, tag=tag,
                        resume=resume, max_segments=max_segments,
                        retries=retries, retry_backoff_s=retry_backoff_s,
                        compile_stats=compile_stats, telemetry=telemetry,
                        mesh=mesh)
                    compile_s += rep.compile_time_s
                    cards.append(rep.cost_card)
                    if outs is None:
                        local[("stopped", rank)] = rep.dispatches
                    else:
                        # the partition's cells ran together: they share
                        # its duration
                        wall = time.perf_counter() - t_part
                        for idx, out in zip(mine.cell_indices, outs):
                            res = results_from_scan(
                                cfgs[idx], setups[idx], out, wall_time_s=wall,
                                dispatches=sum(rep.replays.values()),
                                uses_shapley=key.needs_sv,
                                compile_time_s=rep.compile_time_s,
                                round_time_s=rep.round_time_s,
                                stage_time_s=rep.stage_time_s,
                                graph_launches=rep.graph_launches)
                            local[idx] = (res, {k: v for k, v in out.items()
                                                if k != "carry"})
                        if block == 0:      # one report a replica row
                            local[("report", row)] = PartitionReport(
                                label=key.label,
                                cell_indices=mine.cell_indices,
                                needs_sv=key.needs_sv,
                                uses_local_losses=key.uses_local_losses,
                                n_strategies=len(part.specs),
                                dispatches=rep.dispatches,
                                shapley_evals=sum(
                                    local[i][0].shapley_evals
                                    for i in mine.cell_indices),
                                bytes_resident=rep.bytes_resident,
                                flops_per_dispatch=rep.flops_per_dispatch,
                                peak_bytes=rep.peak_bytes,
                                upload_codec=key.upload_codec,
                                replays=rep.replays,
                                graph_launches=rep.graph_launches,
                                round_time_s=(
                                    sum(rep.round_time_s)
                                    / len(rep.round_time_s)
                                    if rep.round_time_s
                                    else float("nan")),
                                capture_time_s=rep.compile_time_s,
                                stage_time_s=rep.stage_time_s,
                                cost_card=rep.cost_card)
            except Exception as e:
                # cell isolation: a raising partition degrades to per-cell
                # CellFailure entries; KeyboardInterrupt still aborts
                if not isolate_cells:
                    raise
                local = {("failed", rank): (repr(e), traceback.format_exc())}
            if mesh is not None:
                # the rows' results on every rank, through the host
                local = share_results(local, device)
            marks = {k[0]: v for k, v in sorted(
                (k, v) for k, v in local.items() if isinstance(k, tuple)
                and k[0] in ("stopped", "failed"))}
            if "stopped" in marks:
                if telemetry is not None:
                    telemetry.heartbeat(
                        f"partition {pi + 1}: stopped at max_segments="
                        f"{max_segments} ({marks['stopped']} dispatched); "
                        "checkpoints are the resume point", force=True)
                return None
            if "failed" in marks:
                error, tb = marks["failed"]
                if telemetry is not None:
                    for idx in part.cell_indices:
                        telemetry.emit(
                            "cell_failed", cell=idx, error=error,
                            selector=cfgs[idx].selector,
                            seed=cfgs[idx].seed, partition=key.label)
                    telemetry.heartbeat(
                        f"partition {pi + 1}/{len(partitions)} FAILED "
                        f"({key.label}): {error}; "
                        f"{len(part.cell_indices)} cells degraded",
                        force=True)
                per_partition.append([CellFailure(
                    cell=idx, selector=cfgs[idx].selector,
                    seed=cfgs[idx].seed, partition=key.label,
                    error=error, traceback=tb)
                    for idx in part.cell_indices])
                reports.append(PartitionReport(
                    label=key.label, cell_indices=part.cell_indices,
                    needs_sv=key.needs_sv,
                    uses_local_losses=key.uses_local_losses,
                    n_strategies=len(part.specs), dispatches=0,
                    shapley_evals=0, bytes_resident=0,
                    upload_codec=key.upload_codec))
                continue
            if telemetry is not None:
                for idx in part.cell_indices:
                    res, out = local[idx]
                    emit_scan_rounds(
                        telemetry, out, uses_shapley=key.needs_sv,
                        codec_bytes=codec_nbytes(cfgs[idx].upload_codec,
                                                 res.params),
                        model_bytes=sum(x.numel() * x.element_size()
                                        for x in tree_leaves(res.params)),
                        emask=eval_mask(spec.base.rounds,
                                        cfgs[idx].eval_every),
                        cell=idx)
            per_partition.append([local[idx][0]
                                  for idx in part.cell_indices])
            reports.append(_merge_reports(part, [
                v for k, v in sorted(
                    (k, v) for k, v in local.items()
                    if isinstance(k, tuple) and k[0] == "report")]))
    results = interleave(len(spec.cells), partitions, per_partition)
    wall = time.perf_counter() - t_start
    if telemetry is not None:
        done = [r for r in results if not isinstance(r, CellFailure)]
        accs = [r.final_acc for r in done if r.final_acc == r.final_acc]
        fields = {}
        live_cards = [c for c in cards if c is not None]
        if live_cards:
            # the grid's card is the heaviest partition's
            fields["cost_card"] = max(
                live_cards, key=lambda c: (c.get("peak_bytes") or 0,
                                           c.get("flops") or 0))
            if fields["cost_card"].get("peak_bytes") is not None:
                fields["peak_bytes"] = fields["cost_card"]["peak_bytes"]
        telemetry.emit("compile", seconds=compile_s,
                       program="grid_segments", **fields)
        telemetry.emit("run_end", **run_end_payload(
            rounds=spec.base.rounds, wall_time_s=wall,
            compile_time_s=compile_s,
            final_acc=sum(accs) / len(accs) if accs else float("nan"),
            utility_evals=sum(r.shapley_evals for r in done),
            upload_bytes=sum(r.upload_bytes for r in done),
            download_bytes=sum(r.download_bytes for r in done),
            dispatches=sum(r.dispatches for r in reports)))
    return GridResult(
        spec=spec, results=results, partitions=reports,
        rounds_per_segment=rounds_per_segment, n_segments=n_segments,
        wall_time_s=wall)
