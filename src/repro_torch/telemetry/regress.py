"""Bench-regression tier: diff BENCH_torch_*.json against committed
baselines (counterpart of `repro/telemetry/regress.py`).

    PYTHONPATH=src python -m repro_torch.telemetry.regress [--bench-dir .]
        [--baselines benchmarks/baselines_torch]
        [--trajectory BENCH_torch_trajectory.json]

  * `WATCHED` names, per bench schema, the metrics that make the perf
    contract: dotted paths (list indices allowed), a direction, and a
    tolerance band (relative, or absolute for near-zero metrics).  The
    port has no bench schema yet, so the table starts empty; the port's
    benchmark registers its `bench_torch_*` schemas here.
  * `compare_bench` evaluates one current-vs-baseline pair; `run_check`
    sweeps every BENCH_torch_*.json with a registered schema, appends one
    provenance-stamped entry to the BENCH_torch_trajectory.json ledger
    (pass or fail) and reports regressions.
  * the CLI exits nonzero on any regression; `--seed` copies the current
    artifacts into the baseline directory.

Only the port's own artifacts are read: the reference's BENCH_*.json and
its `benchmarks/baselines/` are never globbed.  A schema-tag mismatch
between current and baseline marks the pair `incomparable` (skipped,
reported); re-seed after an intentional format change.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys
from typing import NamedTuple, Optional

from repro_torch.telemetry.events import provenance

TRAJECTORY_SCHEMA = "bench_torch_trajectory/v1"
BENCH_GLOB = "BENCH_torch_*.json"
TRAJECTORY_NAME = "BENCH_torch_trajectory.json"
DEFAULT_BASELINES = "benchmarks/baselines_torch"


class Metric(NamedTuple):
    """One watched metric: where it lives and how far it may drift."""
    path: str                    # dotted path, list indices as [i]
    direction: str               # "lower" | "higher" (which way is better)
    rel_tol: Optional[float] = None   # band as a fraction of baseline
    abs_tol: Optional[float] = None   # band in the metric's own units


# the perf contract per bench schema: schema tag -> tuple of Metric.
# Empty until the port's benchmark registers its `bench_torch_*` schemas;
# host latencies want wide bands, byte and launch counts exact ones.
WATCHED: dict[str, tuple] = {}

_PATH_TOKEN = re.compile(r"([^.\[\]]+)|\[(\d+)\]")


def lookup(obj, path: str):
    """Resolve a dotted/indexed path; None when any hop is missing."""
    cur = obj
    for m in _PATH_TOKEN.finditer(path):
        key, idx = m.group(1), m.group(2)
        try:
            cur = cur[key] if key is not None else cur[int(idx)]
        except (KeyError, IndexError, TypeError):
            return None
    return cur


def check_metric(metric: Metric, current, baseline) -> dict:
    """Evaluate one metric pair into a trajectory record."""
    cur = lookup(current, metric.path)
    base = lookup(baseline, metric.path)
    rec = {"path": metric.path, "direction": metric.direction,
           "current": cur, "baseline": base}
    if not isinstance(cur, (int, float)) or not isinstance(
            base, (int, float)) or isinstance(cur, bool) or isinstance(
            base, bool):
        rec["status"] = "missing"
        return rec
    if metric.abs_tol is not None:
        band = metric.abs_tol
    else:
        band = abs(base) * (metric.rel_tol or 0.0)
    if metric.direction == "lower":
        bound = base + band
        ok = cur <= bound
    else:
        bound = base - band
        ok = cur >= bound
    rec.update(bound=bound, status="ok" if ok else "regressed")
    if base:
        rec["ratio"] = cur / base
    return rec


def compare_bench(schema: str, current: dict, baseline: dict) -> list[dict]:
    """All watched-metric records for one bench pair."""
    return [check_metric(m, current, baseline)
            for m in WATCHED.get(schema, ())]


def _load(path: str) -> Optional[dict]:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def run_check(bench_dir: str, baseline_dir: str,
              trajectory_path: Optional[str]) -> dict:
    """Sweep every BENCH_torch_*.json in `bench_dir` against `baseline_dir`.

    Returns the trajectory entry (status, per-bench metric records,
    notes for anything skipped); when `trajectory_path` is set the entry
    is appended to that provenance-stamped ledger regardless of outcome.
    """
    benches: dict[str, dict] = {}
    notes: list[str] = []
    n_regressed = n_checked = 0
    paths = sorted(glob.glob(os.path.join(bench_dir, BENCH_GLOB)))
    for path in paths:
        name = os.path.basename(path)
        if name == os.path.basename(trajectory_path or TRAJECTORY_NAME):
            continue
        current = _load(path)
        if current is None:
            notes.append(f"{name}: unreadable, skipped")
            continue
        schema = current.get("schema")
        if schema not in WATCHED:
            notes.append(f"{name}: schema {schema!r} has no watched "
                         "metrics, skipped")
            continue
        base_path = os.path.join(baseline_dir, name)
        baseline = _load(base_path)
        if baseline is None:
            notes.append(f"{name}: no baseline at {base_path}, skipped "
                         "(seed with --seed)")
            continue
        if baseline.get("schema") != schema:
            notes.append(f"{name}: schema changed "
                         f"({baseline.get('schema')!r} -> {schema!r}), "
                         "incomparable — re-seed the baseline")
            continue
        metrics = compare_bench(schema, current, baseline)
        benches[name] = {
            "schema": schema,
            "baseline_rev": (baseline.get("provenance") or {}).get("git_rev"),
            "metrics": metrics,
        }
        n_checked += sum(m["status"] != "missing" for m in metrics)
        n_regressed += sum(m["status"] == "regressed" for m in metrics)

    prov = provenance()
    entry = {
        "timestamp": prov["timestamp"],
        "git_rev": prov["git_rev"],
        "backend": prov["backend"],
        "status": "regressed" if n_regressed else "pass",
        "metrics_checked": n_checked,
        "metrics_regressed": n_regressed,
        "benches": benches,
        "notes": notes,
    }
    if trajectory_path:
        append_trajectory(trajectory_path, entry)
    return entry


def append_trajectory(path: str, entry: dict) -> None:
    """Append one entry to the BENCH_torch_trajectory.json ledger."""
    from repro_torch.telemetry.events import write_bench_json

    ledger = _load(path) or {"schema": TRAJECTORY_SCHEMA, "entries": []}
    if ledger.get("schema") != TRAJECTORY_SCHEMA:
        raise ValueError(f"{path} is not a {TRAJECTORY_SCHEMA} ledger "
                         f"(schema={ledger.get('schema')!r})")
    ledger.setdefault("entries", []).append(entry)
    write_bench_json(path, ledger)


def seed_baselines(bench_dir: str, baseline_dir: str) -> list[str]:
    """Copy the current BENCH_torch_*.json artifacts into the baseline
    dir."""
    import shutil

    os.makedirs(baseline_dir, exist_ok=True)
    seeded = []
    for path in sorted(glob.glob(os.path.join(bench_dir, BENCH_GLOB))):
        name = os.path.basename(path)
        if name == TRAJECTORY_NAME:
            continue
        if (_load(path) or {}).get("schema") not in WATCHED:
            continue
        shutil.copy(path, os.path.join(baseline_dir, name))
        seeded.append(name)
    return seeded


def render(entry: dict) -> str:
    lines = []
    for name, bench in sorted(entry["benches"].items()):
        for m in bench["metrics"]:
            mark = {"ok": " ok ", "regressed": "FAIL",
                    "missing": "skip"}[m["status"]]
            cur, base = m["current"], m["baseline"]
            ratio = f" ({m['ratio']:.2f}x)" if "ratio" in m else ""
            lines.append(f"[{mark}] {name}:{m['path']} "
                         f"{m['direction']}-is-better "
                         f"current={cur} baseline={base}{ratio}")
    for note in entry["notes"]:
        lines.append(f"[note] {note}")
    lines.append(f"checked {entry['metrics_checked']} metrics, "
                 f"{entry['metrics_regressed']} regressed -> "
                 f"{entry['status'].upper()}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bench-dir", default=".",
                    help="directory holding the current BENCH_torch_*.json")
    ap.add_argument("--baselines", default=DEFAULT_BASELINES,
                    help="committed baseline directory")
    ap.add_argument("--trajectory", default=None,
                    help="trajectory ledger path (default: "
                         "<bench-dir>/BENCH_torch_trajectory.json; 'none' "
                         "disables the append)")
    ap.add_argument("--seed", action="store_true",
                    help="copy current artifacts into the baseline dir "
                         "instead of checking")
    args = ap.parse_args(argv)

    if args.seed:
        seeded = seed_baselines(args.bench_dir, args.baselines)
        print(f"seeded {len(seeded)} baselines into {args.baselines}: "
              f"{', '.join(seeded)}")
        return 0

    trajectory = args.trajectory
    if trajectory is None:
        trajectory = os.path.join(args.bench_dir, TRAJECTORY_NAME)
    elif trajectory == "none":
        trajectory = None
    entry = run_check(args.bench_dir, args.baselines, trajectory)
    print(render(entry))
    if trajectory:
        print(f"# trajectory -> {trajectory}")
    return 1 if entry["status"] == "regressed" else 0


if __name__ == "__main__":
    sys.exit(main())
