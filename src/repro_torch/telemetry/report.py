"""Render a run/grid summary table from a telemetry JSONL stream.

    PYTHONPATH=src python -m repro_torch.telemetry.report events.jsonl [...]

One row per (run, cell): rounds observed, final accuracy, SV spend and
truncation rate, bytes moved, wall/compile/execute seconds, rounds/sec.
`--json` emits `{"schema_version", "rows"}` machine-readably instead
(the embedded version is the stream schema the rows were folded from, so
CI consumers can refuse streams they do not understand); `--validate`
runs the schema validator first and exits nonzero on a malformed stream
— CI can gate on the exit code directly.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Optional

from repro_torch.telemetry.events import (
    SCHEMA_VERSION, TelemetryError, read_events, validate_events,
)


def _fmt(x, nd=3) -> str:
    if x is None:
        return "-"
    if isinstance(x, float):
        return f"{x:.{nd}f}"
    return str(x)


def summarize(events) -> list[dict]:
    """Fold an event stream into one summary row per (run, cell).

    Cells come from `round_metrics`/`eval` events carrying a `cell`
    field (grid runs); solo runs fold into cell None.  Run-level fields
    (wall, compile, kind) come from `run_start`/`run_end` and are
    repeated on each of the run's cell rows.
    """
    rows: list[dict] = []
    run: Optional[dict] = None
    cells: dict = {}

    def _flush():
        nonlocal run, cells
        if run is None:
            return
        if not cells:
            cells[None] = _new_cell()
        for cell_id in sorted(cells, key=lambda c: (c is None, c)):
            c = cells[cell_id]
            rows.append({
                "run_id": run.get("run_id"), "kind": run.get("kind"),
                "selector": c["selector"] or run.get("selector"),
                "cell": cell_id,
                "rounds": c["rounds"],
                "final_acc": c["final_acc"],
                "utility_evals": c["utility_evals"],
                "sv_truncated_rounds": c["sv_truncated_rounds"],
                "upload_mb": c["upload_bytes"] / 1e6,
                "download_mb": c["download_bytes"] / 1e6,
                "quarantined": c["quarantined"],
                "taps": c["taps"],
                "checkpoints": run.get("checkpoints", 0),
                "segments": run.get("segments", 0),
                "fault_events": run.get("fault_events", 0),
                "wall_s": run.get("wall_time_s"),
                "compile_s": run.get("compile_time_s"),
                "execute_s": run.get("execute_time_s"),
                "rounds_per_sec": run.get("rounds_per_sec"),
            })
        run, cells = None, {}

    def _new_cell() -> dict:
        return {"rounds": 0, "final_acc": None, "utility_evals": 0,
                "sv_truncated_rounds": 0, "upload_bytes": 0,
                "download_bytes": 0, "quarantined": 0, "taps": 0,
                "selector": None}

    for ev in events:
        kind = ev["event"]
        if kind == "run_start":
            _flush()
            run = {"run_id": ev.get("run_id"), "kind": ev.get("kind"),
                   "selector": ev.get("selector"), "checkpoints": 0,
                   "segments": 0, "fault_events": 0}
        elif run is None:       # stream fragment without a run_start
            run = {"run_id": None, "kind": None, "selector": None,
                   "checkpoints": 0, "segments": 0, "fault_events": 0}
        if kind in ("round_metrics", "eval", "round_tap"):
            c = cells.setdefault(ev.get("cell"), _new_cell())
            if kind == "round_metrics":
                c["rounds"] += 1
                c["utility_evals"] += ev.get("utility_evals", 0)
                c["sv_truncated_rounds"] += bool(ev.get("sv_truncated"))
                c["upload_bytes"] += ev.get("upload_bytes", 0)
                c["download_bytes"] += ev.get("download_bytes", 0)
                c["quarantined"] += ev.get("quarantined", 0)
            elif kind == "eval":
                c["final_acc"] = ev.get("test_acc")
            else:
                c["taps"] += 1
        elif kind == "segment_end":
            run["segments"] += 1
        elif kind == "checkpoint_save":
            run["checkpoints"] += 1
        elif kind in ("checkpoint_corrupt", "segment_retry", "cell_failed"):
            run["fault_events"] += 1
        elif kind == "run_end":
            for f in ("wall_time_s", "compile_time_s", "execute_time_s",
                      "rounds_per_sec"):
                run[f] = ev.get(f)
            if ev.get("final_acc") is not None and len(cells) <= 1:
                cells.setdefault(None, _new_cell())
                if cells[None]["final_acc"] is None:
                    cells[None]["final_acc"] = ev["final_acc"]
            _flush()
    _flush()
    return rows


_COLUMNS = (
    ("run_id", "run"), ("kind", "kind"), ("selector", "selector"),
    ("cell", "cell"), ("rounds", "rounds"), ("final_acc", "acc"),
    ("utility_evals", "sv_evals"), ("sv_truncated_rounds", "sv_trunc"),
    ("upload_mb", "up_mb"), ("download_mb", "down_mb"),
    ("quarantined", "quar"), ("fault_events", "faults"),
    ("segments", "segs"), ("checkpoints", "ckpts"),
    ("wall_s", "wall_s"), ("compile_s", "compile_s"),
    ("rounds_per_sec", "rounds/s"),
)


def render_table(rows: list[dict]) -> str:
    if not rows:
        return "(no runs in stream)"
    table = [[h for _, h in _COLUMNS]]
    for r in rows:
        table.append([_fmt(r.get(k)) for k, _ in _COLUMNS])
    widths = [max(len(row[i]) for row in table)
              for i in range(len(_COLUMNS))]
    lines = []
    for j, row in enumerate(table):
        lines.append("  ".join(c.rjust(w) for c, w in zip(row, widths)))
        if j == 0:
            lines.append("  ".join("-" * w for w in widths))
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("paths", nargs="+", help="JSONL event files")
    ap.add_argument("--json", action="store_true",
                    help="emit summary rows as JSON instead of a table")
    ap.add_argument("--validate", action="store_true",
                    help="schema-validate the stream before summarising")
    args = ap.parse_args(argv)

    events = []
    for p in args.paths:
        events.extend(read_events(p))
    if args.validate:
        try:
            n = validate_events(events)
        except TelemetryError as e:
            print(f"validation FAILED: {e}", file=sys.stderr)
            return 1
        print(f"# validated {n} events", file=sys.stderr)
    rows = summarize(events)
    if args.json:
        json.dump({"schema_version": SCHEMA_VERSION, "rows": rows},
                  sys.stdout, indent=2)
        print()
    else:
        print(render_table(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
