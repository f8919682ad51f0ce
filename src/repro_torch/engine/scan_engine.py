"""engine="scan": a whole federated run with no host sync between rounds
(counterpart of `repro/engine/scan_engine.py`).

The batched engine (`round_engine.RoundEngine`) runs a round as one call
but keeps selection on the host, so every round waits for the card: the
cohort is read back, the Shapley truncation test is read back, the kernel
wrappers check their inputs on the host.  Here selection, the straggler
E_k gather, the cohort gather, local training, the upload codec,
GTG-Shapley, ModelAverage, the cumulative-SV update and the cadenced eval
all stay on the card (`round_engine._make_scan_body`), and on a CUDA
device one round is captured as a CUDA graph and replayed T times
(`round_engine.make_segment_step`); the eval is a second graph, replayed
after the rounds the host's eval table names.  The host reads the outputs
back once a segment: once a run by default, or once every
`rounds_per_segment` rounds.  On the CPU the same functions run eagerly.

This module is the host side: the run's static tables (per-round epoch
budgets, the Power-of-Choice candidate schedule, the eval table) and the
FLResult bookkeeping (byte ledger, virtual-clock replay, eval history)
from the outputs read back.  The segments themselves (draws staged on the
card before the replays, one read-back after) are driven by
`grid.segments.run_segments`, the grid's driver, with one replica.  `round_time_s` is the replays' device time
(CUDA events; the host clock on the CPU) divided by the rounds; the
capture (warm-up included) is `compile_time_s`, the host's draw staging
`stage_time_s`.  `dispatches` counts graph replays.

Parity: on one device the scan makes the batched engine's run bit for
bit (same draws, same ops; a finished straggler keeps its params through a
device select, and a truncated round computes its walk and zeroes it).
Faults and the quarantine screen run inside the captured round (the
cohort's codes gathered from a device copy of the fault table by the
round counter); the quarantined counts come back with the segment's other
outputs.  Telemetry is built from the segments' read-back (the reference's
stream: `compile` with the round's cost card, per-round `round_metrics` /
`eval`, `run_end`); the live tap and the stage-timed capture are
`telemetry.trace`'s.  Client sharding and the serial Shapley estimator
raise `NotImplementedError`, each naming its slice.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core.selection import poc_d_schedule
from repro_torch.engine.round_engine import (
    RoundSpec, ScanOperands, ScanSpec, SegmentCarry, round_plan,
)
from repro_torch.engine.schedule import (
    VirtualClock, deadline_epochs_table, eval_mask, round_duration_s,
    straggler_epochs_table,
)
from repro_torch.faults.spec import CODE_CRASH, CODE_NONE
from repro_torch.federated.compression import codec_nbytes
from repro_torch.kernels.ce_loss.ops import check_labels
from repro_torch.telemetry.metrics import emit_scan_rounds, run_end_payload
from repro_torch.telemetry.profile import trace_capture
from repro_torch.telemetry.trace import CompileTimer


def build_epochs_table(cfg, s) -> np.ndarray:
    """(T, N) int32 local-epoch budgets for every round of a scan run: the
    deadline table under a schedule, else the straggler table `setup_run`
    drew (shared with the other engines), else, at straggler_rev = 0, a
    table drawn here (the same distribution as the lazy draws, another
    stream), else E everywhere."""
    e = cfg.client.epochs
    if s.clock is not None:
        return deadline_epochs_table(s.clock, cfg.schedule, cfg.rounds, e)
    if s.epochs_table is not None:
        return s.epochs_table
    if s.straggler_ids:
        return straggler_epochs_table(s.rng, cfg.rounds, cfg.n_clients,
                                      s.straggler_ids, e)
    return np.full((cfg.rounds, cfg.n_clients), e, np.int32)


def build_fault_table(cfg, s) -> np.ndarray:
    """(T, N) int32 fault codes for a scan run: the table `setup_run` drew
    (shared with the other engines), zeros when faults are off."""
    if s.fault_table is not None:
        return np.asarray(s.fault_table, np.int32)
    return np.zeros((cfg.rounds, cfg.n_clients), np.int32)


def scan_operands(cfg, s) -> ScanOperands:
    """A solo run's operands on its device.  The validation labels and the
    fault codes are range-checked here, once, so the captured round reads
    nothing back for them."""
    device = s.n_valid.device
    table = build_epochs_table(cfg, s)
    faults = build_fault_table(cfg, s)
    if faults.size and (faults.min() < CODE_NONE or faults.max() > CODE_CRASH):
        raise ValueError(f"fault codes must lie in [{CODE_NONE}, "
                         f"{CODE_CRASH}], got [{faults.min()}, "
                         f"{faults.max()}]")

    def dev(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    with torch.no_grad():
        n_classes = s.model.apply(s.params, s.x_val[:1]).shape[-1]
    check_labels(s.y_val, n_classes)
    return ScanOperands(
        xs_all=s.xs, ys_all=s.ys, nv_all=s.n_valid,
        sigma_all=dev(s.sigma_k_all, torch.float32),
        x_val=s.x_val, y_val=s.y_val, x_test=s.x_test, y_test=s.y_test,
        fractions=dev(s.fractions, torch.float32),
        epochs_table=dev(table, torch.int64),
        fault_table=dev(faults, torch.int64),
        d_sched=dev(poc_d_schedule(s.sel_spec, cfg.rounds), torch.int64),
        eval_table=eval_mask(cfg.rounds, cfg.eval_every),
        strategy_id=torch.zeros((), dtype=torch.int64, device=device),
        n_steps=int(table.max(initial=0)) * cfg.client.batches_per_epoch)


def make_scan_spec(cfg, selector_specs: tuple, *,
                   rounds_per_segment: int = 0,
                   live_tap: bool = False) -> ScanSpec:
    """ScanSpec for an FLConfig; `selector_specs` may hold several
    strategies (SV is computed if any of them needs it)."""
    needs_sv = any(sp.uses_shapley for sp in selector_specs)
    rspec = RoundSpec(needs_sv=needs_sv, shapley_impl=cfg.shapley_impl,
                      shapley_eps=cfg.shapley_eps,
                      shapley_max_iters=cfg.shapley_max_iters or 50 * cfg.m,
                      sv_chunk=cfg.sv_chunk, upload_codec=cfg.upload_codec,
                      faults=cfg.faults, quarantine=cfg.quarantine,
                      quarantine_z=cfg.quarantine_z)
    return ScanSpec(round=rspec, selectors=tuple(selector_specs),
                    rounds=cfg.rounds, rounds_per_segment=rounds_per_segment,
                    live_tap=live_tap)


def check_draws(draws_seg, n_clients: int, m: int) -> None:
    """Raise ValueError unless a segment's walks index [0, M) and its
    drawn cohorts [0, N).  They are host tensors, checked where they are
    made, so the captured round reads nothing back for them."""
    for what, x, hi in (("walks", draws_seg.walks, m),
                        ("cohort draws", draws_seg.selection.choice,
                         n_clients)):
        if x is not None and x.numel() and (int(x.min()) < 0
                                            or int(x.max()) >= hi):
            raise ValueError(f"{what} must index [0, {hi}), got "
                             f"[{int(x.min())}, {int(x.max())}]")


def results_from_scan(cfg, s, out: dict, *, wall_time_s: float,
                      dispatches: int, uses_shapley: bool,
                      compile_time_s: float = 0.0, round_time_s=(),
                      stage_time_s: float = 0.0, graph_launches=None):
    """The FLResult of a scan run from its outputs read back to the host
    (numpy arrays with a leading round axis, the final valuation and eval
    count, and the final carry on the device)."""
    from repro_torch.federated.server import FLResult   # cycle-free here

    sels, epochs = out["selections"], out["epochs"]
    emask = eval_mask(cfg.rounds, cfg.eval_every)
    if out["eval_count"] != int(emask.sum()):
        raise RuntimeError(
            f"the eval-slot counter recorded {out['eval_count']} evals but "
            f"the eval table (rounds={cfg.rounds}, eval_every="
            f"{cfg.eval_every}) expects {int(emask.sum())}")
    vclock = VirtualClock() if s.clock is not None else None
    if vclock is not None:
        for t in range(cfg.rounds):
            vclock.advance(round_duration_s(s.clock, cfg.schedule, sels[t],
                                            epochs[t]))
    test_acc = [(int(t) + 1, float(out["test_acc"][t]))
                for t in np.flatnonzero(emask)]
    val_loss = [(int(t) + 1, float(out["val_loss"][t]))
                for t in np.flatnonzero(emask)]
    carry = out["carry"]
    return FLResult(
        config=cfg, test_acc=test_acc, val_loss=val_loss,
        final_acc=test_acc[-1][1] if test_acc else float("nan"),
        sv_final=out["sv_final"], selection_counts=out["counts"],
        selections=[row.astype(np.int64) for row in sels],
        shapley_evals=(int(out["utility_evals"].sum()) if uses_shapley
                       else 0),
        wall_time_s=wall_time_s, params=carry.params,
        # uploads are charged at the granted cohort of each round
        upload_bytes=codec_nbytes(cfg.upload_codec, s.params)
        * int(out["granted"].sum()),
        download_bytes=s.model_bytes * cfg.m * cfg.rounds,
        sim_time_s=vclock.now_s if vclock is not None else 0.0,
        dispatches=dispatches, compile_time_s=compile_time_s,
        execute_time_s=max(wall_time_s - compile_time_s, 0.0),
        quarantined_total=int(out["quarantined"].sum()),
        round_time_s=tuple(round_time_s), shapley_time_s=(),
        stage_time_s=stage_time_s, graph_launches=graph_launches)


_READ = ("selections", "epochs", "sv", "utility_evals", "sv_truncated",
         "test_acc", "val_loss", "granted", "quarantined")


def read_back(named: dict) -> dict:
    """Device tensors to numpy in one device-to-host copy, so one sync:
    their bytes are packed on the device and split on the host."""
    flat = torch.cat([t.contiguous().reshape(-1).view(torch.uint8)
                      for t in named.values()])
    host, out, i = flat.cpu().numpy(), {}, 0
    for name, t in named.items():
        n = t.numel() * t.element_size()
        dtype = torch.empty((0,), dtype=t.dtype).numpy().dtype
        out[name] = np.frombuffer(host[i:i + n].tobytes(),
                                  dtype).reshape(tuple(t.shape))
        i += n
    return out


def run_federated_scan(cfg, s, t_start: float, *,
                       rounds_per_segment: int = 0, telemetry=None,
                       ctimer=None):
    """Run `cfg.rounds` rounds from the RunSetup `s` as segments of
    captured round replays (one segment unless `rounds_per_segment` > 0),
    reading the outputs back once a segment: `grid.segments.run_segments`
    with one replica.

    `telemetry=None` adds nothing.  With a sink the run's events are built
    from the read-back after the segments: `compile` (the kernel build and
    capture seconds `ctimer` saw, and the round's cost card), then per
    round `round_metrics` / `eval`, then `run_end`; no event comes from
    inside a segment except the live tap's (`telemetry.live_tap`), and
    `telemetry.trace_dir` wraps the segments in a profiler window."""
    from repro_torch.grid.segments import ReplicaBatch, run_segments

    uses_shapley = s.sel_spec.uses_shapley
    spec = make_scan_spec(cfg, (s.sel_spec,),
                          rounds_per_segment=rounds_per_segment,
                          live_tap=bool(telemetry is not None
                                        and telemetry.live_tap))
    ops = scan_operands(cfg, s)
    plan = round_plan(spec.round, cfg.client, spec.selectors, cfg.n_clients,
                      cfg.m, s.params, s.n_valid.cpu().numpy())
    carry = SegmentCarry(s.params, s.sel_state, torch.zeros(
        (), dtype=torch.int64, device=ops.nv_all.device))
    if ctimer is None:
        ctimer = CompileTimer()
    with ctimer, trace_capture(telemetry, label="run_scan"):
        (out,), rep = run_segments(s.model, cfg.client, spec, ReplicaBatch(
            cfgs=(cfg,), setups=(s,), ops=(ops,), plans=(plan,),
            carries=(carry,)), telemetry=telemetry, segment_events=False)
    res = results_from_scan(
        cfg, s, out, wall_time_s=time.perf_counter() - t_start,
        dispatches=sum(rep.replays.values()), uses_shapley=uses_shapley,
        compile_time_s=rep.compile_time_s, round_time_s=rep.round_time_s,
        stage_time_s=rep.stage_time_s, graph_launches=rep.graph_launches)
    if telemetry is not None:
        telemetry.emit("compile", seconds=ctimer.seconds, program="run_scan",
                       cost_card=rep.cost_card)
        emit_scan_rounds(
            telemetry, out, uses_shapley=uses_shapley,
            codec_bytes=codec_nbytes(cfg.upload_codec, s.params),
            model_bytes=s.model_bytes,
            emask=eval_mask(cfg.rounds, cfg.eval_every))
        telemetry.emit("run_end", **run_end_payload(
            rounds=cfg.rounds, wall_time_s=res.wall_time_s,
            compile_time_s=res.compile_time_s, final_acc=res.final_acc,
            utility_evals=res.shapley_evals,
            upload_bytes=res.upload_bytes, download_bytes=res.download_bytes,
            sv_rounds=cfg.rounds if uses_shapley else 0,
            truncated_rounds=(int(out["sv_truncated"].sum())
                              if uses_shapley else 0),
            dispatches=res.dispatches))
    return res
