"""repro_torch.telemetry — structured observability for every engine
(counterpart of `repro.telemetry`, the same event schema and `__all__`).

`Telemetry` is the sink all engines accept (`telemetry=None` default: no
added launch, replay, sync or file, and bit-identical outputs); `events`
defines the schema-versioned JSONL stream, its validator and the
provenance-stamped BENCH_torch_*.json writer; `metrics` aggregates host
gauges at segment boundaries; `trace` carries stage annotation, the
compile-time split (kernel build and graph capture) and the live tap out
of the captured round; `report` renders summaries from JSONL.

On top of the stream: `profile` attaches per-step cost cards to compile
events and drives the `torch.profiler` capture window; `merge` folds
per-process JSONL shards into one validated stream; `regress` diffs the
port's BENCH_torch_*.json artifacts against committed baselines.
"""
from repro_torch.telemetry.events import (
    SCHEMA_VERSION, Telemetry, TelemetryError, provenance, read_events,
    read_events_prefix, validate_events, write_bench_json,
)
from repro_torch.telemetry.metrics import (
    emit_scan_rounds, run_end_payload, segment_counters,
)
from repro_torch.telemetry.profile import (
    cached_cost_card, cost_card, stage_wall_from_trace, trace_capture,
)
from repro_torch.telemetry.trace import (
    CompileTimer, live_sink, named_stage, record_spans, stage,
)

__all__ = [
    "SCHEMA_VERSION", "Telemetry", "TelemetryError", "provenance",
    "read_events", "read_events_prefix", "validate_events",
    "write_bench_json",
    "emit_scan_rounds", "run_end_payload", "segment_counters",
    "cached_cost_card", "cost_card", "stage_wall_from_trace",
    "trace_capture",
    "CompileTimer", "live_sink", "named_stage", "record_spans", "stage",
]
