"""Host-side counters and gauges over engine outputs: no extra launch
(counterpart of `repro/telemetry/metrics.py`).

The scan engine reads its outputs back once a segment (the segment's one
sync); per-round telemetry is built from that read-back, on the host, at
the segment boundary, so it costs no kernel launch and no extra sync.

  * `emit_scan_rounds` unrolls a run's stacked (T, ...) outputs into
    per-round `round_metrics` / `eval` events (the authoritative stream;
    the live tap is diagnostics only);
  * `segment_counters`: one segment's aggregate gauges (rounds/sec, SV
    truncation count, utility-eval spend) for `segment_end` events and the
    grid heartbeat;
  * `run_end_payload`: the run-level rollup (rounds/sec, SV truncation
    rate, evals per accuracy point, byte totals, compile/execute split).

The outputs are the port's read-back dicts of numpy arrays
(`grid/segments.py`, the keys of `scan_engine._READ`).
"""
from __future__ import annotations

from typing import Optional

import numpy as np


def emit_scan_rounds(tel, out, *, uses_shapley: bool, codec_bytes: int,
                     model_bytes: int, emask, cell: Optional[int] = None,
                     t0: int = 0) -> None:
    """Per-round events from stacked scan outputs (host-side, post-run).

    `out` is a read-back dict holding (T, M) selections/epochs/sv and (T,) counters;
    `emask` is the cell's (T,) bool eval cadence (schedule.eval_mask) —
    eval events are emitted where it is set, from the same stacked
    accuracy/loss rows the FLResult curve is rebuilt from.
    """
    sels = np.asarray(out["selections"])
    epochs = np.asarray(out["epochs"])
    sv = np.asarray(out["sv"])
    evals = np.asarray(out["utility_evals"])
    trunc = np.asarray(out["sv_truncated"])
    acc = np.asarray(out["test_acc"])
    vloss = np.asarray(out["val_loss"])
    emask = np.asarray(emask)
    m = int(sels.shape[1]) if sels.ndim > 1 else 0
    # uploads are charged at the round's ACTUAL granted-cohort size —
    # dropout strategies can grant fewer than m active clients — matching
    # the loop engine's per-selected-client ledger (replicated.py)
    granted = np.asarray(out["granted"])
    quar = np.asarray(out["quarantined"])
    extra = {} if cell is None else {"cell": cell}
    for i in range(sels.shape[0]):
        t = t0 + i
        fields = dict(
            round=int(t), selections=sels[i], epochs=epochs[i],
            utility_evals=int(evals[i]), sv_truncated=bool(trunc[i]),
            upload_bytes=codec_bytes * int(granted[i]),
            download_bytes=model_bytes * m, **extra)
        if uses_shapley:
            fields["sv"] = sv[i]
        if quar[i]:
            fields["quarantined"] = int(quar[i])
        tel.emit("round_metrics", **fields)
        if emask[t]:
            tel.emit("eval", round=int(t), test_acc=float(acc[i]),
                     val_loss=float(vloss[i]), **extra)


def segment_counters(outs: list, seconds: float) -> dict:
    """Aggregate gauges of one segment: its replicas' read-back dicts."""
    evals = np.stack([o["utility_evals"] for o in outs])
    trunc = np.stack([o["sv_truncated"] for o in outs])
    k_rounds, n_replicas = int(evals.shape[1]), len(outs)
    counters = {
        "rounds": k_rounds,
        "replicas": n_replicas,
        "seconds": seconds,
        "rounds_per_sec": k_rounds / seconds if seconds > 0 else None,
        "utility_evals": int(evals.sum()),
        "sv_truncated_rounds": int(trunc.sum()),
    }
    counters["quarantined"] = int(sum(o["quarantined"].sum() for o in outs))
    return counters


def run_end_payload(*, rounds: int, wall_time_s: float,
                    compile_time_s: float, final_acc: float,
                    utility_evals: int, upload_bytes: int,
                    download_bytes: int, sv_rounds: int = 0,
                    truncated_rounds: int = 0, dispatches: int = 0) -> dict:
    """The `run_end` event payload: run-level counters and derived gauges.

    * `rounds_per_sec` uses execute time (wall minus compile) — the
      steady-state number a capacity plan needs; wall stays reported.
    * `sv_truncation_rate` = truncated SV rounds / rounds that ran SV.
    * `evals_per_acc_point` = utility evals per final-accuracy percentage
      point — the "what did the valuation spend buy" gauge the paper's
      budget framing asks for (lower is better; None without evals/acc).
    """
    execute_s = max(wall_time_s - compile_time_s, 0.0)
    acc_points = final_acc * 100.0
    return {
        "wall_time_s": wall_time_s,
        "compile_time_s": compile_time_s,
        "execute_time_s": execute_s,
        "rounds": rounds,
        "rounds_per_sec": rounds / execute_s if execute_s > 0 else None,
        "dispatches": dispatches,
        "final_acc": None if final_acc != final_acc else final_acc,
        "utility_evals": utility_evals,
        "sv_truncation_rate":
            truncated_rounds / sv_rounds if sv_rounds else None,
        "evals_per_acc_point":
            utility_evals / acc_points
            if utility_evals and acc_points == acc_points and acc_points > 0
            else None,
        "upload_bytes": upload_bytes,
        "download_bytes": download_bytes,
    }
