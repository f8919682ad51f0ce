"""Segmented execution of a partition's replicas (counterpart of
`repro/grid/segments.py`).

A partition's S replicas run as one `SegmentStep` of S runs
(`engine/round_engine.py`): on the card, one captured graph holds the S
round bodies and is replayed once a round; a second holds the S evals.
`run_segments` chains the segments of K = `rounds_per_segment` rounds (a
last one shorter where K does not divide T); the solo scan
(`scan_engine.run_federated_scan`) is its case of one replica and no
checkpoint directory:

  * before a segment, each replica's K rounds of draws are made on the
    host (its own `RunDraws`, in its solo run's order) and staged;
  * after it, the S replicas' outputs, final valuations, eval counts and
    cohort-gather error words come back in one device-to-host copy, the
    segment's one sync;
  * with a `checkpoint_dir`, the carries, the outputs, the replay time a
    round and each replica's draw-source state are saved at the boundary
    (`checkpoint.save_carry`), so a killed run resumes from the last
    complete segment bit for bit: the carry is the exact state and the
    draw sources continue where they stopped.

With a telemetry sink `run_segments` emits `segment_start` /
`segment_end` (with `telemetry.segment_counters`), `segment_retry`,
`checkpoint_save` / `checkpoint_load` / `checkpoint_corrupt`, a throttled
heartbeat with an ETA, and the first dispatched segment's `compile` event
with the step's cost card; with `live_tap` its host thread emits the
rounds' taps as they land.  All of it reads what the segment reads back
anyway, so the outputs and the replays stay what they are without it.

Segmenting only changes where the host observes the carry, so a segmented
run equals the unsegmented one bit for bit.  The reference stacks the
replicas on a leading axis for its vmap, padded to the partition's largest
client capacity; here each replica keeps its solo run's operands, so a
grid cell makes its solo run's exact ops.
"""
from __future__ import annotations

import glob
import os
import re
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.checkpoint.ckpt import (
    CheckpointCorruptError, leaves_with_paths, load_carry, rebuild_like,
    save_carry,
)
from repro_torch.engine.round_engine import ScanSpec, SegmentStep
from repro_torch.engine.scan_engine import _READ, check_draws, read_back
from repro_torch.federated.draws import stack_rounds
from repro_torch.telemetry import profile, trace
from repro_torch.telemetry.metrics import segment_counters


class ReplicaBatch(NamedTuple):
    """A partition's replicas, one entry each, in partition order."""
    cfgs: tuple          # FLConfig
    setups: tuple        # RunSetup (its `draws` is the replica's source)
    ops: tuple           # ScanOperands, strategy_id into the partition's
                         # selector tuple
    plans: tuple         # DrawPlan of the replica's solo run
    carries: tuple       # SegmentCarry at round 0


class SegmentRunReport(NamedTuple):
    n_segments: int
    dispatches: int              # segments run by THIS call
    resumed_segments: int        # segments restored from checkpoints
    bytes_resident: int
    compile_time_s: float = 0.0  # the capture, warm-up included
    replays: Optional[dict] = None   # the rest as in PartitionReport
    graph_launches: Optional[dict] = None
    round_time_s: tuple = ()     # per round, shared by the replicas
    stage_time_s: float = 0.0
    cost_card: Optional[dict] = None   # with compile_stats or a sink
    flops_per_dispatch: float = float("nan")
    peak_bytes: Optional[int] = None


def segment_plan(rounds: int, rounds_per_segment: int) -> tuple[int, int]:
    """A grid's (K, n_segments); K=0 means unsegmented.  A grid's K must
    divide T, the reference grid's rule, so that a GridSpec and K run on
    both packages or on neither; `run_segments` itself takes a last,
    shorter segment, as the solo scan does."""
    k = rounds_per_segment or rounds
    if k <= 0 or rounds % k != 0:
        raise ValueError(
            f"rounds_per_segment={rounds_per_segment} must divide "
            f"rounds={rounds} (the reference grid's rule)")
    return k, rounds // k


def batch_bytes(batch: ReplicaBatch) -> int:
    """Device bytes of the replicas' operands and carries."""
    return sum(x.numel() * x.element_size()
               for x in _tensors((batch.ops, batch.carries)))


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (tuple, list, dict)):
        for v in (x.values() if isinstance(x, dict) else x):
            yield from _tensors(v)


def _out_like(m: int, k: int) -> dict:
    """A segment's outputs of one replica on the host (the dtypes of
    `SegmentStep`'s buffers)."""
    z = np.zeros
    return {"selections": z((k, m), np.int64), "epochs": z((k, m), np.int64),
            "sv": z((k, m), np.float32), "utility_evals": z((k,), np.int32),
            "sv_truncated": z((k,), bool), "test_acc": z((k,), np.float32),
            "val_loss": z((k,), np.float32), "granted": z((k,), np.int64),
            "quarantined": z((k,), np.int32)}


def _seg_path(checkpoint_dir: str, tag: str, seg: int) -> str:
    return os.path.join(checkpoint_dir, f"{tag}seg{seg:04d}.npz")


def saved_segments(checkpoint_dir: str, tag: str) -> int:
    """Length of the contiguous checkpointed-segment prefix on disk."""
    pat = re.compile(re.escape(tag) + r"seg(\d{4})\.npz$")
    have = set()
    for p in glob.glob(os.path.join(checkpoint_dir, f"{tag}seg*.npz")):
        mt = pat.search(os.path.basename(p))
        if mt:
            have.add(int(mt.group(1)))
    n = 0
    while n in have:
        n += 1
    return n


def _final_state(carry) -> dict:
    """What a run's results read from its last carry, as device tensors."""
    val = carry.sel_state.valuation
    return {"sv_final": val.sv, "counts": val.counts,
            "eval_count": carry.eval_slot}


def _replay_segment(step, carries, t0, n, draws_segs, n_clients,
                    read_carries: bool, poller=None):
    """Stage, replay and read back one segment of n rounds: (outputs, host
    dict, host carries or None, replay seconds, staging seconds).  The
    outputs, the final states, the error words and, with `read_carries`,
    the carries come back in one device-to-host copy.  A live-tap
    `poller` watches the step's tap rings over the replays."""
    cuda = step.device.type == "cuda"
    capture_s = step.capture_time_s
    t_stage = time.perf_counter()
    step.stage(carries, t0, draws_segs)
    stage_s = (time.perf_counter() - t_stage
               - (step.capture_time_s - capture_s))
    if poller is not None:
        poller.arm(step.tap_rings, t0, n)
    if cuda:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
    t_replay = time.perf_counter()
    step.replay(t0, n)
    if cuda:
        end.record()
    outs = step.output(n)
    named = {}
    for i, (o, err) in enumerate(zip(outs, step.errors)):
        named.update({f"{i}/{name}": getattr(o, name) for name in _READ})
        named.update({f"{i}/{name}": x
                      for name, x in _final_state(o.carry).items()})
        named[f"{i}/error"] = err
        if read_carries:
            named.update({f"{i}/carry/{p}": t
                          for p, t in leaves_with_paths(o.carry)})
    host = read_back(named)
    for i in range(len(outs)):
        if int(host[f"{i}/error"][0]):
            raise IndexError(f"cohort ids must index [0, {n_clients}), got "
                             f"{int(host[f'{i}/error'][0])}")
    host_carries = None
    if read_carries:
        host_carries = [rebuild_like(o.carry, iter(
            host[f"{i}/carry/{p}"] for p, _ in leaves_with_paths(o.carry)))
            for i, o in enumerate(outs)]
    replay_s = (start.elapsed_time(end) / 1e3 if cuda
                else time.perf_counter() - t_replay)
    trace.record_device_stages(step.stage_seconds())
    return outs, host, host_carries, replay_s, stage_s


def _card_key(spec: ScanSpec, ccfg, batch: ReplicaBatch) -> tuple:
    """What a step's cost card depends on: the spec, the client config and
    the shapes of the replicas' operands and carries."""
    return ("segment_step", spec._replace(rounds_per_segment=0), ccfg,
            profile.shape_signature((batch.ops, batch.carries)))


def run_segments(model, ccfg, spec: ScanSpec, batch: ReplicaBatch, *,
                 checkpoint_dir: Optional[str] = None, tag: str = "",
                 resume: bool = True, max_segments: Optional[int] = None,
                 retries: int = 0, retry_backoff_s: float = 0.05,
                 compile_stats: bool = False, telemetry=None,
                 segment_events: bool = True
                 ) -> tuple[Optional[list], SegmentRunReport]:
    """Drive one partition's replicas through all segments of K =
    `spec.rounds_per_segment` rounds (0: one segment of T), the last one
    shorter where K does not divide T.

    Returns (outputs, report): one dict a replica of numpy arrays with a
    leading round axis (`scan_engine._READ`), plus the final `carry` on the
    device and `sv_final`, `counts` and `eval_count` on the host, the form
    `scan_engine.results_from_scan` reads.  The outputs are None when
    `max_segments` stopped the run early (the checkpoints on disk are then
    the resume point).

    A checkpoint that fails its integrity checks is treated as absent: the
    run falls back to the last intact boundary and recomputes forward,
    overwriting the bad file.  `retries` > 0 retries a raising segment up
    to that many times, `retry_backoff_s` doubling a retry, from the same
    carries and the same draws.

    `telemetry` (default None: no event, no thread, no extra sync) emits
    the module's segment, checkpoint and compile events unless
    `segment_events=False` (the solo scan's stream is the reference's: its
    engine emits the run's events itself); its `live_tap` runs the tap's
    host thread over the replays and its `trace_dir` has the step time
    each stage of its replays.  `compile_stats` (or a sink) fills the
    report's cost card: the FLOPs of the round counted in the eager run
    the step makes anyway, the launches its graph holds and, on a card,
    the peak memory above the set-up."""
    rounds = spec.rounds
    k = spec.rounds_per_segment or rounds
    n_segments = -(-rounds // k)
    tel = telemetry if segment_events else None
    card_key = _card_key(spec, ccfg, batch)
    card = profile.lookup_card(card_key)
    want_card = compile_stats or telemetry is not None
    if want_card and card is None:
        profile.prepare_counting()
    step = SegmentStep(
        model, ccfg, spec._replace(rounds_per_segment=k), list(batch.ops),
        stage_events=bool(telemetry is not None
                          and getattr(telemetry, "trace_dir", None)),
        count_flops=want_card and card is None)
    draws = [s.draws for s in batch.setups]
    n_rep, m, n_clients = len(batch.ops), spec.selectors[0].m, \
        spec.selectors[0].n_clients
    carries = list(batch.carries)
    parts = [{name: [] for name in _READ} for _ in range(n_rep)]
    round_times: list = []
    host = None

    def seg_rounds(seg: int) -> int:
        return min(k, rounds - seg * k)

    # ---- resume: restore the contiguous checkpointed prefix --------------
    start = 0
    if checkpoint_dir and resume:
        start = limit = min(saved_segments(checkpoint_dir, tag), n_segments)
        for seg in range(limit):
            n = seg_rounds(seg)
            like = {"replicas": [{"carry": c, "out": _out_like(m, n)}
                                 for c in carries],
                    "round_time_s": np.zeros((n,))}
            path = _seg_path(checkpoint_dir, tag, seg)
            try:
                snap = load_carry(path, like, draws, telemetry=tel)
            except CheckpointCorruptError as e:
                # recompute from here on, from the last intact boundary
                if tel is not None:
                    tel.emit("checkpoint_corrupt", path=path, segment=seg,
                             tag=tag, error=str(e))
                start = seg
                break
            carries = [r["carry"] for r in snap["replicas"]]
            for part, r in zip(parts, snap["replicas"]):
                for name in _READ:
                    part[name].append(r["out"][name])
            round_times += list(snap["round_time_s"])

    stage_s, dispatched = 0.0, 0
    ctimer = trace.CompileTimer()
    peak_bytes, seg_seconds = None, []
    cuda = step.device.type == "cuda"
    if want_card and cuda:
        # no synchronise: the sink must add no host sync to the run
        mem_base = torch.cuda.memory_allocated(step.device)
        torch.cuda.reset_peak_memory_stats(step.device)

    def report():
        flops = (card or {}).get("flops")
        return SegmentRunReport(
            n_segments, dispatched, start, batch_bytes(batch),
            compile_time_s=step.capture_time_s,
            replays=dict(step.replays),
            graph_launches=(dict(step.graph_launches)
                            if step.graphs is not None else None),
            round_time_s=tuple(round_times), stage_time_s=stage_s,
            cost_card=card,
            flops_per_dispatch=(flops * k if flops is not None
                                else float("nan")),
            peak_bytes=(card or {}).get("peak_bytes"))

    live = spec.live_tap and telemetry is not None
    with trace.live_sink(telemetry if live else None) as poller:
        for seg in range(start, n_segments):
            if max_segments is not None and dispatched >= max_segments:
                return None, report()
            t0, n = seg * k, seg_rounds(seg)
            t_seg = time.perf_counter()
            if tel is not None:
                tel.emit("segment_start", segment=seg, t0=t0, rounds=n,
                         tag=tag, replicas=n_rep)
            t_draw = time.perf_counter()
            draws_segs = []
            for s, plan in zip(batch.setups, batch.plans):
                d = stack_rounds([s.draws.round(t, plan)
                                  for t in range(t0, t0 + n)])
                check_draws(d, n_clients, m)
                draws_segs.append(d)
            stage_s += time.perf_counter() - t_draw
            attempt = 0
            while True:
                try:
                    with ctimer:
                        outs, host, host_carries, replay_s, seg_stage_s = \
                            _replay_segment(step, carries, t0, n, draws_segs,
                                            n_clients, bool(checkpoint_dir),
                                            poller)
                    break
                except Exception:
                    # KeyboardInterrupt is a BaseException: never retried
                    if attempt >= retries:
                        raise
                    attempt += 1
                    if tel is not None:
                        tel.emit("segment_retry", segment=seg,
                                 attempt=attempt, tag=tag)
                    time.sleep(retry_backoff_s * (2 ** (attempt - 1)))
            stage_s += seg_stage_s
            carries = [o.carry for o in outs]
            seg_out = [{name: host[f"{i}/{name}"] for name in _READ}
                       for i in range(n_rep)]
            for part, out in zip(parts, seg_out):
                for name in _READ:
                    part[name].append(out[name])
            round_times += [replay_s / n] * n
            if want_card and dispatched == 0:
                if cuda:
                    peak_bytes = (torch.cuda.max_memory_allocated(step.device)
                                  - mem_base)
                card = card if card is not None else profile.cached_card(
                    card_key, lambda: profile.card(
                        step.flops.get("round"),
                        kernel_launches=(dict(step.graph_launches["round"])
                                         if step.graphs is not None
                                         else None),
                        peak_bytes=peak_bytes) | {
                            "eval_flops": step.flops.get("eval")})
                if tel is not None:
                    tel.emit("compile", seconds=ctimer.seconds,
                             program=f"segment_step:{tag or 'solo'}",
                             cost_card=card)
            dispatched += 1
            if tel is not None:
                secs = time.perf_counter() - t_seg
                seg_seconds.append(secs)
                tel.emit("segment_end", segment=seg, tag=tag,
                         **segment_counters(seg_out, secs))
                eta_s = (sum(seg_seconds) / len(seg_seconds)
                         * (n_segments - seg - 1))
                peak_txt = ("" if peak_bytes is None
                            else f" peak {peak_bytes / 1e6:.0f}MB")
                tel.heartbeat(f"{tag or 'seg'} {seg + 1}/{n_segments} "
                              f"({n} rounds x {n_rep} replicas, "
                              f"{secs:.2f}s) eta {eta_s:.0f}s{peak_txt}")
            if checkpoint_dir:
                save_carry(_seg_path(checkpoint_dir, tag, seg), {
                    "replicas": [{"carry": c, "out": o}
                                 for c, o in zip(host_carries, seg_out)],
                    "round_time_s": np.full((n,), replay_s / n)}, draws,
                    telemetry=tel)
            if poller is not None:
                poller.finish()

    results = []
    for i, (part, carry) in enumerate(zip(parts, carries)):
        out = {name: np.concatenate(p) for name, p in part.items()}
        # the last segment's read-back holds the final state; a run whose
        # every segment was restored reads it from the restored carry
        final = ({name: host[f"{i}/{name}"] for name in _final_state(carry)}
                 if host is not None else
                 {name: x.cpu().numpy()
                  for name, x in _final_state(carry).items()})
        out.update(carry=carry, sv_final=final["sv_final"],
                   counts=final["counts"],
                   eval_count=int(final["eval_count"]))
        results.append(out)
    return results, report()
