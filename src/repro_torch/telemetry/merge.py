"""Merge per-process telemetry JSONL shards into one validated stream.

    PYTHONPATH=src python -m repro_torch.telemetry.merge shard*.jsonl -o merged.jsonl

A multi-host run gives every process its own `Telemetry` sink (same
`run_id`, per-host file) — the ROADMAP's multi-host-grid prerequisite.
Each shard's envelope is self-consistent (per-sink gap-free `seq`,
monotonic sink-relative `t_s`), so merging is a sort, not a renumber of
anything meaningful:

  1. every shard is gap-checked and schema-validated on its own (a
     truncated shard from a killed process is readable up to the cut —
     `read_events_prefix` — and the cut is reported per shard);
  2. with K > 1 shards, events are annotated with their source `shard`
     index and original `src_seq`, then stably merged by `t_s` — ties
     keep shard order, and a shard's internal order is always preserved
     because per-sink `t_s` is monotonic (seq-preserving per sink);
  3. the merged envelope gets a fresh gap-free global `seq` and the
     result is re-validated (`validate_events` scopes its round-ordering
     checks per shard, so interleaved per-process streams do not false-
     positive).

Merging one shard is the identity (no annotation, no renumbering) —
pinned by tests.  `t_s` is sink-relative: cross-shard interleaving is
only as aligned as the sinks' creation times, which for a multi-host
launch (all processes start together) is what a reader wants; per-shard
order is exact regardless.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Optional, Sequence

from repro_torch.telemetry.events import (
    TelemetryError, read_events, read_events_prefix, validate_events,
)


def shard_run_ids(events) -> set:
    """The run_ids announced by a shard's run_start events."""
    return {ev.get("run_id") for ev in events if ev.get("event") == "run_start"}


def merge_streams(shards: Sequence[list], *,
                  run_id: Optional[str] = None) -> list[dict]:
    """Merge K per-process event streams into one validated stream.

    `run_id` filters to the shards that announce that run (a shared log
    directory may hold strays from other runs); with it unset, all
    shards are merged.  Raises TelemetryError when a shard fails its own
    gap-check/schema validation, when `run_id` matches no shard, or when
    the merged stream fails re-validation.
    """
    picked: list[tuple[int, list]] = []
    for i, events in enumerate(shards):
        try:
            validate_events(events)
        except TelemetryError as e:
            raise TelemetryError(f"shard {i} failed validation: {e}") from e
        if run_id is not None and run_id not in shard_run_ids(events):
            continue
        picked.append((i, events))
    if not picked:
        raise TelemetryError(
            f"no shard announces run_id {run_id!r} "
            f"(searched {len(shards)} shards)")
    if len(picked) == 1:
        return list(picked[0][1])

    annotated = []
    for i, events in picked:
        for ev in events:
            rec = dict(ev)
            rec["shard"] = i
            rec["src_seq"] = ev["seq"]
            annotated.append(rec)
    annotated.sort(key=lambda ev: ev["t_s"])   # stable: ties keep shard order
    for seq, rec in enumerate(annotated):
        rec["seq"] = seq
    validate_events(annotated)
    return annotated


def merge_files(paths: Sequence[str], *, run_id: Optional[str] = None,
                tolerate_truncation: bool = True
                ) -> tuple[list[dict], list[dict]]:
    """Read, gap-check, and merge shard files.

    Returns `(merged_events, shard_reports)`; each report records the
    shard's path, event count, and — when `tolerate_truncation` let a
    killed process's shard load as a prefix — where the cut was.
    """
    shards, reports = [], []
    for p in paths:
        if tolerate_truncation:
            events, cut = read_events_prefix(p)
        else:
            events, cut = read_events(p), None
        shards.append(events)
        reports.append({"path": p, "events": len(events), "cut": cut})
    return merge_streams(shards, run_id=run_id), reports


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("paths", nargs="+", help="per-process JSONL shards")
    ap.add_argument("-o", "--out", default=None,
                    help="merged JSONL output path (default: stdout)")
    ap.add_argument("--run-id", default=None,
                    help="merge only shards announcing this run_id")
    ap.add_argument("--strict", action="store_true",
                    help="refuse truncated shards instead of merging "
                         "their readable prefix")
    args = ap.parse_args(argv)

    try:
        merged, reports = merge_files(args.paths, run_id=args.run_id,
                                      tolerate_truncation=not args.strict)
    except (TelemetryError, ValueError, OSError) as e:
        print(f"merge failed: {e}", file=sys.stderr)
        return 1
    for rep in reports:
        note = (f" (truncated at line {rep['cut']['line']})"
                if rep["cut"] else "")
        print(f"# shard {rep['path']}: {rep['events']} events{note}",
              file=sys.stderr)
    print(f"# merged {len(reports)} shards -> {len(merged)} events "
          "(validated)", file=sys.stderr)
    out = open(args.out, "w") if args.out else sys.stdout
    try:
        for ev in merged:
            json.dump(ev, out)
            out.write("\n")
    finally:
        if args.out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
