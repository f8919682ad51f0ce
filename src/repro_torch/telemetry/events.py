"""Schema-versioned structured telemetry: the JSONL event stream
(counterpart of `repro/telemetry/events.py`, schema version 1, the same
event types and required fields, so a stream of either package validates
under the other's `validate_events` and renders under the other's
`report`).

`Telemetry` is the one handle every engine takes (always as an optional
keyword defaulting to None: the telemetry-off path adds no kernel launch,
graph replay, host sync or file, and leaves every output bit for bit what
it is).  Events are append-only JSONL records with a fixed envelope:

    {"v": 1, "seq": 0, "t_s": 0.000012, "event": "run_start", ...}

  * `v`    the stream schema version (SCHEMA_VERSION);
  * `seq`  per-sink monotonic sequence number, gap-free: `emit` takes a
           lock, since the live tap's host thread (trace.py) emits beside
           the main thread;
  * `t_s`  seconds since the sink was created (`time.perf_counter`).

`validate_events` checks the envelope, the types, the seq chain and that
`round_metrics` / `eval` rounds strictly increase per (run, cell).  The
device-originated `round_tap` stream is exempt from ordering.

`provenance()` / `write_bench_json` stamp benchmark artifacts with the git
rev, a timestamp, the backend, device count, torch / CUDA / Python
versions and the card's name and power limit (nvidia-smi), so every number
on disk says where it came from.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
import uuid
from typing import Any, IO, Optional

SCHEMA_VERSION = 1

# envelope fields every event carries (emitted by `Telemetry.emit`)
ENVELOPE_FIELDS = ("v", "seq", "t_s", "event")

# event type -> payload fields that MUST be present (beyond the envelope).
# `compile` events may carry a `cost_card` (profile.py); `profile` events
# close a capture window (trace dir + per-stage seconds).
REQUIRED_FIELDS: dict[str, tuple] = {
    "run_start": ("run_id", "kind"),
    "compile": ("seconds",),
    "profile": ("trace_dir",),
    "segment_start": ("segment", "t0"),
    "segment_end": ("segment", "seconds"),
    "round_metrics": ("round", "selections", "epochs", "utility_evals",
                      "sv_truncated", "upload_bytes", "download_bytes"),
    "round_tap": ("round",),          # device-origin live tap (trace.py)
    "serve_step": ("step",),          # serving decode steps
    "eval": ("round", "test_acc", "val_loss"),
    "checkpoint_save": ("path", "nbytes"),
    "checkpoint_load": ("path",),
    # faults: corrupted checkpoints found at resume, bounded segment
    # retries, and isolated grid-cell failures
    "checkpoint_corrupt": ("path",),
    "segment_retry": ("segment", "attempt"),
    "cell_failed": ("cell", "error"),
    "run_end": ("wall_time_s",),
}

# host-authoritative per-round streams whose `round` index must strictly
# increase within one (run, cell); the asynchronous `round_tap` stream is
# not here
_ORDERED_ROUND_EVENTS = ("round_metrics", "eval")


class TelemetryError(ValueError):
    """An event stream violated the schema contract."""


def _sanitize(x: Any) -> Any:
    """Coerce numpy scalars and arrays and host torch tensors into plain
    JSON-able Python, at emit time, so the in-memory `events` list is
    exactly what a JSONL reader parses back.  A CUDA tensor raises: the
    engines read their device values back before they emit, and a hidden
    device-to-host copy here would be a sync."""
    if isinstance(x, (str, int, float, bool)) or x is None:
        return x
    if isinstance(x, dict):
        return {str(k): _sanitize(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_sanitize(v) for v in x]
    device = getattr(x, "device", None)
    if device is not None and getattr(device, "type", "cpu") != "cpu":
        raise TelemetryError(
            f"a {device} tensor reached emit; read device values back "
            "before emitting them")
    tolist = getattr(x, "tolist", None)   # numpy arrays, torch tensors
    if tolist is not None and getattr(x, "ndim", 0):
        return _sanitize(tolist())
    item = getattr(x, "item", None)       # zero-dim scalars
    if item is not None:
        return _sanitize(item())
    return str(x)


class Telemetry:
    """A telemetry sink: JSONL event stream + throttled progress heartbeat.

    * `path=None` keeps events in memory only (`.events`); with a path,
      every event is appended and flushed, so a killed run leaves a
      readable prefix.
    * `live_tap=True` opts the scan engines into the live tap: the
      captured round copies each round's record into a pinned host ring
      and a host thread emits `round_tap` events as the rounds land
      (trace.py).  It must not change any output.
    * `trace_dir` opts the engines into a `torch.profiler` capture window
      around the run (profile.trace_capture): a Chrome trace lands in a
      run_id-stamped subdirectory and a `profile` event reports the
      seconds of each stage.  On the card the scan then captures its round
      as one graph a stage, with CUDA events between them.
    * `heartbeat_every_s` throttles progress lines (0 = every call); lines
      go to `stream` (default stderr), never into the event file.
    """

    def __init__(self, path: Optional[str] = None, *,
                 live_tap: bool = False, heartbeat_every_s: float = 0.0,
                 stream: Optional[IO] = None, run_id: Optional[str] = None,
                 trace_dir: Optional[str] = None):
        self.path = path
        self.live_tap = bool(live_tap)
        self.trace_dir = trace_dir
        self.run_id = run_id or f"run-{uuid.uuid4().hex[:8]}"
        self.events: list[dict] = []
        self.heartbeat_every_s = float(heartbeat_every_s)
        self._stream = stream if stream is not None else sys.stderr
        self._seq = 0
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()
        self._last_hb = -float("inf")
        self._f: Optional[IO] = None
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._f = open(path, "a")

    # ---- event stream ----------------------------------------------------
    def emit(self, event: str, **fields) -> dict:
        if event not in REQUIRED_FIELDS:
            raise TelemetryError(f"unknown event type {event!r}; known: "
                                 f"{sorted(REQUIRED_FIELDS)}")
        missing = [f for f in REQUIRED_FIELDS[event] if f not in fields]
        if missing:
            raise TelemetryError(
                f"event {event!r} missing required fields {missing}")
        payload = {k: _sanitize(v) for k, v in fields.items()}
        with self._lock:
            rec = {"v": SCHEMA_VERSION, "seq": self._seq,
                   "t_s": round(time.perf_counter() - self._t0, 6),
                   "event": event}
            rec.update(payload)
            self._seq += 1
            self.events.append(rec)
            if self._f is not None:
                json.dump(rec, self._f)
                self._f.write("\n")
                self._f.flush()
        return rec

    # ---- progress heartbeat ---------------------------------------------
    def heartbeat(self, msg: str, *, force: bool = False) -> None:
        now = time.perf_counter()
        if not force and now - self._last_hb < self.heartbeat_every_s:
            return
        self._last_hb = now
        print(f"[telemetry {self.run_id}] {msg}", file=self._stream,
              flush=True)

    # ---- lifecycle -------------------------------------------------------
    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None

    def __enter__(self) -> "Telemetry":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def read_events(path: str) -> list[dict]:
    """Parse a JSONL event file back into a list of event dicts."""
    events = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                events.append(json.loads(line))
    return events


def read_events_prefix(path: str) -> tuple[list[dict], Optional[dict]]:
    """Parse a JSONL event file tolerating a truncated or corrupt tail:
    `(events, cut)`, with `cut` None for a clean file or `{"line",
    "reason", "raw"}` for the first bad line (everything after it is
    ignored)."""
    events: list[dict] = []
    cut = None
    with open(path) as f:
        for i, line in enumerate(f):
            stripped = line.strip()
            if not stripped:
                continue
            try:
                events.append(json.loads(stripped))
            except ValueError as e:
                cut = {"line": i, "reason": str(e), "raw": stripped[:120]}
                break
    return events, cut


def validate_events(events) -> int:
    """Pure-Python schema check over an event stream; returns the count.

    Raises TelemetryError on: missing envelope fields, version mismatch,
    unknown event type, non-gap-free `seq`, missing required payload
    fields, or a non-increasing `round` within one (run, cell) of the
    ordered streams.  Runs are delimited by `run_start` events; a merged
    stream's events carry their `shard`, and ordering is tracked per shard.
    """
    prev_seq = None
    run_ordinals: dict = {}
    last_round: dict[tuple, int] = {}
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            raise TelemetryError(f"event {i} is not an object: {ev!r}")
        for f in ENVELOPE_FIELDS:
            if f not in ev:
                raise TelemetryError(f"event {i} missing envelope "
                                     f"field {f!r}: {ev}")
        if ev["v"] != SCHEMA_VERSION:
            raise TelemetryError(
                f"event {i} has schema version {ev['v']!r}; this "
                f"validator understands {SCHEMA_VERSION}")
        kind = ev["event"]
        if kind not in REQUIRED_FIELDS:
            raise TelemetryError(f"event {i} has unknown type {kind!r}")
        missing = [f for f in REQUIRED_FIELDS[kind] if f not in ev]
        if missing:
            raise TelemetryError(
                f"event {i} ({kind}) missing required fields {missing}")
        seq = ev["seq"]
        if prev_seq is not None and seq != prev_seq + 1:
            raise TelemetryError(
                f"event {i} breaks the seq chain: {prev_seq} -> {seq}")
        prev_seq = seq
        shard = ev.get("shard")
        if kind == "run_start":
            run_ordinals[shard] = run_ordinals.get(shard, -1) + 1
        if kind in _ORDERED_ROUND_EVENTS:
            scope = (shard, run_ordinals.get(shard, -1), kind,
                     ev.get("cell"))
            rnd = ev["round"]
            if not isinstance(rnd, int):
                raise TelemetryError(
                    f"event {i} ({kind}) round index must be an int, "
                    f"got {rnd!r}")
            if scope in last_round and rnd <= last_round[scope]:
                raise TelemetryError(
                    f"event {i} ({kind}, cell={ev.get('cell')}) round "
                    f"index not increasing: {last_round[scope]} -> {rnd}")
            last_round[scope] = rnd
    return len(events)


# ---- provenance-stamped benchmark artifacts ------------------------------

def _git_rev() -> Optional[str]:
    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True, text=True,
            timeout=10, cwd=os.path.dirname(os.path.abspath(__file__)))
        return out.stdout.strip() or None if out.returncode == 0 else None
    except (OSError, subprocess.SubprocessError):
        return None


def _card() -> tuple[Optional[str], Optional[float]]:
    """The first card's name and power limit (W) as nvidia-smi reports
    them; (None, None) without a card or without nvidia-smi."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None, None
    lines = out.stdout.strip().splitlines()
    if out.returncode or not lines:
        return None, None
    name, _, limit = lines[0].rpartition(",")
    try:
        watts = float(limit.strip().split()[0])
    except (ValueError, IndexError):
        watts = None
    return name.strip() or None, watts


def provenance() -> dict:
    """Where a number came from: rev, time, backend, devices, versions and
    the card's name and power limit."""
    import torch
    cuda = torch.cuda.is_available()
    name, watts = _card() if cuda else (None, None)
    return {
        "git_rev": _git_rev(),
        "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
        "backend": "cuda" if cuda else "cpu",
        "device_count": torch.cuda.device_count() if cuda else 1,
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "python_version": sys.version.split()[0],
        "device_name": name,
        "power_limit_w": watts,
    }


def write_bench_json(path: str, report: dict) -> dict:
    """The single BENCH_torch_*.json writer: stamp provenance, dump
    sorted.  Every report carries its `schema` tag (e.g.
    "bench_torch_engine/v1") plus a `provenance` block."""
    if "schema" not in report:
        raise ValueError("bench reports must carry a 'schema' tag "
                         "(e.g. 'bench_torch_engine/v1')")
    stamped = dict(report)
    stamped["provenance"] = provenance()
    with open(path, "w") as f:
        json.dump(_sanitize(stamped), f, indent=2, sort_keys=True)
        f.write("\n")
    return stamped
