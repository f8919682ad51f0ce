"""Stage tracing, the compile-time split and the live tap (counterpart of
`repro/telemetry/trace.py`).

All of it leaves every output bit for bit what it is:

  * `stage(name)` / `named_stage(name)`: stage annotation.  `stage` is a
    host span around a region (`torch.profiler.record_function` named
    `repro.<name>`, plus an NVTX range when a card is present) and feeds
    `record_spans()`'s SpanRecorder.  `named_stage` is the scope planted in
    the round bodies (select / train / codec / quarantine / shapley /
    aggregate / eval): run eagerly it is the same profiler range and NVTX
    range, metadata only.  Inside a CUDA-graph capture a span cannot
    replay, so, when the sink asks for a capture window, the scan captures
    its round through `StageCapture`: each `named_stage` boundary ends one
    graph and begins the next (one shared memory pool), and the engine
    records a CUDA timing event before each piece's replay and after the
    last.  The elapsed times give each stage's device time over every
    replay; the plain (one graph) round is not captured then.

  * `CompileTimer`: what the port pays once a run in place of jit
    compiles: the nvcc build of the kernels (`kernels.library()`, when it
    happens inside the window) and the CUDA-graph capture of the scan's
    round (`SegmentStep._capture`, warm-up included).  Both report through
    `add_compile_seconds` to every active timer.

  * the live tap (`ScanSpec.live_tap`): the captured round copies its tap
    record (round, strategy id, the M selections, the M SVs, utility
    evals, truncation) into its slot of a device ring and then the ring
    and its sequence words into pinned host memory, as two small memcpy
    nodes of the graph (`attach_live_tap`); nothing in the round reads the
    card back.  A host thread started by `live_sink` polls the host rings
    and emits `round_tap` events (`origin="device"`) as rounds land.  A
    ring has one slot a round of the segment (a grid replica has its own
    ring), so nothing is overwritten before the segment's read-back; what
    the thread has not emitted by then is emitted after the segment's
    `segment_end`.  On the CPU the rings are plain tensors and the same
    thread drains them.  As in the reference, a tap carries no cell index.
"""
from __future__ import annotations

import contextlib
import threading
import time
import warnings
from typing import Iterator, Optional

import numpy as np
import torch

# stage names planted by the engines
STAGES = ("select", "train", "codec", "quarantine", "shapley", "aggregate",
          "eval")

# prefix every span carries; profile.py sums spans with this prefix out of
# a capture window's trace
SPAN_PREFIX = "repro."


_NVTX: Optional[bool] = None


def _nvtx() -> bool:
    """NVTX ranges only where a card is present (checked once)."""
    global _NVTX
    if _NVTX is None:
        _NVTX = torch.cuda.is_available()
    return _NVTX


class SpanRecorder:
    """Host record of `stage()` spans (name -> total wall seconds) and of
    the device seconds a stage-split graph's events measured."""

    def __init__(self) -> None:
        self.spans: list[tuple[str, float]] = []
        self.device: dict[str, float] = {}

    def add(self, name: str, seconds: float) -> None:
        self.spans.append((name, seconds))

    def add_device(self, totals: dict) -> None:
        for name, secs in totals.items():
            self.device[name] = self.device.get(name, 0.0) + secs

    def totals(self) -> dict[str, float]:
        out: dict[str, float] = {}
        for name, secs in self.spans:
            out[name] = out.get(name, 0.0) + secs
        return out


_span_recorder: Optional[SpanRecorder] = None


@contextlib.contextmanager
def record_spans() -> Iterator[SpanRecorder]:
    """Install a SpanRecorder for the enclosed region (an inner recorder
    shadows the outer one for its extent)."""
    global _span_recorder
    prev = _span_recorder
    rec = SpanRecorder()
    _span_recorder = rec
    try:
        yield rec
    finally:
        _span_recorder = prev


def record_device_stages(totals: dict) -> None:
    """Hand per-stage device seconds to the active recorder, if any."""
    if _span_recorder is not None and totals:
        _span_recorder.add_device(totals)


@contextlib.contextmanager
def _range(name: str) -> Iterator[None]:
    nvtx = _nvtx()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


@contextlib.contextmanager
def stage(name: str) -> Iterator[None]:
    """Host span around a region of launches."""
    rec = _span_recorder
    t0 = time.perf_counter() if rec is not None else 0.0
    with _range(f"{SPAN_PREFIX}{name}"):
        yield
    if rec is not None:
        rec.add(name, time.perf_counter() - t0)


# ---- stage-split capture -------------------------------------------------

_stage_capture: Optional["StageCapture"] = None


class StageCapture:
    """Captures a function as one CUDA graph a stage: `named_stage`
    boundaries inside it end the current graph and begin the next, all in
    one memory pool, so the pieces replayed in order do what one graph of
    the function does.  `pieces` is [(stage, CUDAGraph)]; code outside any
    stage is labelled "other".  Run it on a side stream, as
    `torch.cuda.graph` does, in `capture_error_mode` ("thread_local" for a
    round that holds NCCL collectives)."""

    def __init__(self, capture_error_mode: str = "global") -> None:
        self.pool = torch.cuda.graph_pool_handle()
        self.pieces: list = []
        self._labels = ["other"]
        self._graph = None
        self._mode = capture_error_mode

    def _begin(self) -> None:
        self._graph = torch.cuda.CUDAGraph()
        self._graph.capture_begin(pool=self.pool,
                                  capture_error_mode=self._mode)

    def _end(self) -> None:
        with warnings.catch_warnings():
            # a stage that ends where another begins leaves an empty piece
            warnings.filterwarnings("ignore", message=".*CUDA Graph is empty")
            self._graph.capture_end()
        self.pieces.append((self._labels[-1], self._graph))
        self._graph = None

    def enter(self, name: str) -> None:
        self._end()
        self._labels.append(name)
        self._begin()

    def exit(self) -> None:
        self._end()
        self._labels.pop()
        self._begin()

    def run(self, fn) -> None:
        global _stage_capture
        self._begin()
        _stage_capture = self
        try:
            fn()
        except BaseException:
            _stage_capture = None
            if self._graph is not None:
                try:
                    self._graph.capture_end()
                except Exception:
                    pass
            self.reset()
            raise
        _stage_capture = None
        self._end()

    def reset(self) -> None:
        for _, g in self.pieces:
            g.reset()
        self.pieces = []


@contextlib.contextmanager
def named_stage(name: str) -> Iterator[None]:
    """The scope planted in the round bodies: a profiler and NVTX range
    run eagerly, a graph boundary inside a StageCapture."""
    cap = _stage_capture
    if cap is not None:
        cap.enter(name)
        try:
            yield
        finally:
            cap.exit()
        return
    with _range(f"{SPAN_PREFIX}{name}"):
        yield


class StageTimer:
    """CUDA timing events around each replay of a StageCapture's pieces:
    `replay(pieces)` records an event before each piece and one after the
    last; `totals()` (after the work synchronised) sums the device seconds
    of each stage over every timed replay."""

    def __init__(self) -> None:
        self._runs: list = []

    def replay(self, pieces) -> None:
        events = [torch.cuda.Event(enable_timing=True)
                  for _ in range(len(pieces) + 1)]
        for ev, (_, g) in zip(events, pieces):
            ev.record()
            g.replay()
        events[-1].record()
        self._runs.append(([label for label, _ in pieces], events))

    def totals(self) -> dict[str, float]:
        out: dict[str, float] = {}
        for labels, events in self._runs:
            for label, a, b in zip(labels, events, events[1:]):
                out[label] = out.get(label, 0.0) + a.elapsed_time(b) / 1e3
        self._runs = []
        return out


# ---- compile-time attribution --------------------------------------------

_active_timers: list["CompileTimer"] = []
_timer_lock = threading.Lock()


def add_compile_seconds(seconds: float) -> None:
    """Charge `seconds` of one-off work (a kernel build, a graph capture)
    to every active CompileTimer."""
    with _timer_lock:
        for t in _active_timers:
            t.seconds += seconds


class CompileTimer:
    """Accumulates the port's one-off seconds (kernel build, graph
    capture) while active.  Re-enterable: one timer may wrap several
    regions of a run, accumulating into `.seconds`; each active timer sees
    everything paid in its own window."""

    def __init__(self) -> None:
        self.seconds = 0.0

    def __enter__(self) -> "CompileTimer":
        with _timer_lock:
            _active_timers.append(self)
        return self

    def __exit__(self, *exc) -> None:
        with _timer_lock:
            _active_timers.remove(self)


# ---- the live tap --------------------------------------------------------

class TapRing:
    """One scan run's tap ring: `k` slots (one a round of a segment) of
    int64 records [round, strategy id, utility evals, truncated, the M
    selections, the M SVs' float32 bits], a device copy written by slot
    and a host copy (pinned on a card) the whole ring is copied to each
    round, then the sequence words (round + 1, 0 = empty) after it."""

    def __init__(self, k: int, m: int, device: torch.device):
        self.k, self.m = k, m
        width = 4 + 2 * m
        pin = device.type == "cuda"
        self.dev_rec = torch.zeros((k, width), dtype=torch.int64,
                                   device=device)
        self.dev_seq = torch.zeros((k,), dtype=torch.int64, device=device)
        self.host_rec = torch.zeros((k, width), dtype=torch.int64,
                                    pin_memory=pin)
        self.host_seq = torch.zeros((k,), dtype=torch.int64, pin_memory=pin)
        # numpy views, made once: the poller reads no tensor
        self.rec_np = self.host_rec.numpy()
        self.seq_np = self.host_seq.numpy()

    def clear(self) -> None:
        """Empty the ring before a segment's replays (the card's earlier
        copies have all landed: the last read-back synchronised)."""
        self.dev_seq.zero_()
        self.seq_np[:] = 0

    def record(self, slot: int) -> Optional[dict]:
        rec = self.rec_np[slot].copy()
        m = self.m
        return {"round": int(rec[0]), "strategy_id": int(rec[1]),
                "utility_evals": int(rec[2]),
                "sv_truncated": bool(rec[3]),
                "selections": rec[4:4 + m].tolist(),
                "sv": rec[4 + m:].astype(np.int32).view(np.float32).tolist()}


def attach_live_tap(ring: TapRing, slot, t, strategy_id, sel, sv,
                    utility_evals, sv_truncated) -> None:
    """Plant the tap in a round body: write round t's record into `slot`
    (a device index) of the device ring, then copy the ring and its
    sequence words to the host ring without waiting (memcpy nodes of a
    captured round)."""
    def col(x):
        return torch.as_tensor(x, device=ring.dev_rec.device).to(
            torch.int64).reshape(-1)

    rec = torch.cat([col(t), col(strategy_id), col(utility_evals),
                     col(sv_truncated), col(sel),
                     sv.to(torch.float32).view(torch.int32).to(torch.int64)])
    ring.dev_rec.index_copy_(0, slot, rec[None])
    ring.dev_seq.index_copy_(0, slot, col(t) + 1)
    ring.host_rec.copy_(ring.dev_rec, non_blocking=True)
    ring.host_seq.copy_(ring.dev_seq, non_blocking=True)


def round_tap(telemetry, *, round, strategy_id, selections, sv,
              utility_evals, sv_truncated) -> None:
    """One `round_tap` event (origin "device") of a landed tap record."""
    telemetry.emit("round_tap", round=round, origin="device",
                   strategy_id=strategy_id, selections=selections, sv=sv,
                   utility_evals=utility_evals, sv_truncated=sv_truncated)


class LivePoller:
    """The host thread of the live tap: polls the armed rings and emits
    each round's tap as its sequence word lands."""

    def __init__(self, telemetry, interval_s: float = 1e-3):
        self.telemetry = telemetry
        self.interval_s = interval_s
        self._lock = threading.Lock()
        self._armed: list = []          # [ring, t0, n, next slot]
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="repro-live-tap")
        self._thread.start()

    def arm(self, rings, t0: int, n: int) -> None:
        """Watch slots [0, n) of `rings` for rounds t0 .. t0 + n - 1."""
        with self._lock:
            self._armed = [[ring, t0, n, 0] for ring in rings]

    def _poll(self) -> int:
        emitted = 0
        with self._lock:
            for entry in self._armed:
                ring, t0, n, nxt = entry
                while nxt < n and ring.seq_np[nxt] == t0 + nxt + 1:
                    round_tap(self.telemetry, **ring.record(nxt))
                    nxt += 1
                    emitted += 1
                entry[3] = nxt
        return emitted

    def finish(self) -> None:
        """After a segment's read-back (every copy has landed): emit what
        the thread has not, and disarm.  Raises if a round never landed."""
        self._poll()
        with self._lock:
            missing = [(e[1] + e[3], e[1] + e[2]) for e in self._armed
                       if e[3] < e[2]]
            self._armed = []
        if missing:
            raise RuntimeError(f"live tap: rounds {missing} never landed in "
                               "the host ring")

    def _loop(self) -> None:
        while not self._stop.is_set():
            self._poll()
            time.sleep(self.interval_s)

    def close(self) -> None:
        self._stop.set()
        self._thread.join()


@contextlib.contextmanager
def live_sink(telemetry) -> Iterator[Optional[LivePoller]]:
    """Start the live tap's host thread for `telemetry` over the enclosed
    segments (yields None, and starts nothing, for None)."""
    if telemetry is None:
        yield None
        return
    poller = LivePoller(telemetry)
    try:
        yield poller
    finally:
        poller.close()
