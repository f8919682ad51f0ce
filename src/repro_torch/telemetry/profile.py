"""Device-cost profiling: per-step cost cards and the capture window
(counterpart of `repro/telemetry/profile.py`).

  * `cost_card(fn, *args)`: one eager run of `fn` under
    `torch.utils.flop_counter`'s formulas gives `flops`, the matrix-product
    FLOPs of the run (matmuls, convolutions, attention; the hand-written
    kernels and elementwise work are not counted).  `card(...)` assembles a card from counts an engine
    measured itself: the scan counts its round body's FLOPs in the eager
    run it makes anyway (the capture's warm-up on a card, the first round
    on the CPU), its `kernel_launches` are the launches its captured round
    holds, and `peak_bytes` is `torch.cuda.max_memory_allocated` above the
    set-up (None on the CPU).  `roofline.compute_s` is `flops` at the
    H100's float32 CUDA-core peak (the port turns TF32 off).  XLA's
    `bytes_accessed` has no torch counterpart: it is left out, not
    estimated, and the roofline block names the term it lacks.
    `cached_cost_card` memoises by (fn, arg shapes and dtypes), so a warm
    step pays nothing.

  * `trace_capture(telemetry, label)`: the opt-in `torch.profiler` window
    (`Telemetry(trace_dir=...)`; CPU activities, plus CUDA on a card): a
    Chrome trace lands in `<trace_dir>/<run_id>/`, and on exit one
    `profile` event reports the seconds of each stage, from the device
    events of a stage-split captured round (`source="graph_events"`), else
    from the `repro.<stage>` spans of the exported trace
    (`source="trace"`), else from the host SpanRecorder (`source="host"`).
    A window opened while the profiler already runs degrades to host spans.

The H100 SXM rates below are `chip_smoke.py`'s; they live here until the
port has its `launch/roofline.py`.
"""
from __future__ import annotations

import contextlib
import glob
import gzip
import json
import os
from typing import Any, Iterator, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.telemetry.trace import SPAN_PREFIX, record_spans

F32_PEAK_FLOPS = 67e12      # H100 SXM float32 outside the tensor cores
TF32_PEAK_FLOPS = 495e12    # H100 SXM TF32 tensor cores, dense
BF16_PEAK_FLOPS = 989e12    # H100 SXM bf16 tensor cores, dense
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3


class FlopCount(TorchDispatchMode):
    """`with FlopCount() as fc: ...; fc.get_total_flops()`: the
    matrix-product FLOPs (matmuls, convolutions, attention) of the
    enclosed ops, by `torch.utils.flop_counter`'s formulas, each op run as
    it is.  FlopCounterMode itself first tries to decompose an op it has
    no formula for, which costs seconds on a full round and runs other
    kernels than the plain run."""

    def __init__(self) -> None:
        super().__init__()
        self.total = 0

    def get_total_flops(self) -> int:
        return self.total

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.utils.flop_counter import flop_registry
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.total += formula(*args, **kwargs, out_val=out)
        return out


_MODE_READY = False


def prepare_counting() -> None:
    """Pay, once a process, what the first dispatch mode costs (torch
    imports its decomposition tables then: ~2 s on a workstation, ~9 s on
    the card's host), on a CPU scalar and outside any timed window."""
    global _MODE_READY
    if not _MODE_READY:
        with FlopCount():
            torch.zeros(()) + 1
        _MODE_READY = True


def card(flops: Optional[float], *, kernel_launches: Optional[dict] = None,
         peak_bytes: Optional[int] = None) -> dict:
    """A cost card from measured counts."""
    out: dict = {"flops": flops, "kernel_launches": kernel_launches,
                 "peak_bytes": peak_bytes}
    if flops is not None:
        out["roofline"] = {
            "compute_s": flops / F32_PEAK_FLOPS,
            "peak_flops": F32_PEAK_FLOPS,
            "hbm_bytes_per_s": HBM_BYTES_PER_S,
            "memory_s": None,
            "dominant": None,
            "lacks": "bytes_accessed",
        }
    return out


def cost_card(fn, *args, **kwargs) -> dict:
    """Run `fn(*args, **kwargs)` once, eagerly, under the FLOP counter;
    the card of that run (peak bytes above the start on a card)."""
    cuda = torch.cuda.is_available() and any(
        isinstance(a, torch.Tensor) and a.is_cuda
        for a in _leaves((args, kwargs)))
    if cuda:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    with FlopCount() as fc:
        fn(*args, **kwargs)
    peak = None
    if cuda:
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
    return card(float(fc.get_total_flops()), peak_bytes=peak)


def _leaves(x):
    if isinstance(x, dict):
        for v in x.values():
            yield from _leaves(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _leaves(v)
    else:
        yield x


def shape_signature(tree) -> tuple:
    """(shape, dtype, device type) of each tensor leaf, repr of the rest."""
    return tuple((tuple(x.shape), str(x.dtype), x.device.type)
                 if isinstance(x, torch.Tensor) else repr(x)
                 for x in _leaves(tree))


# (fn, arg signature) -> card.  Keys hold strong references; the callers'
# functions are few and long-lived.
_CARD_CACHE: dict = {}


def cached_card(key, make) -> dict:
    """The card cached under `key`, made by `make()` on first sight."""
    if key not in _CARD_CACHE:
        _CARD_CACHE[key] = make()
    return _CARD_CACHE[key]


def lookup_card(key) -> Optional[dict]:
    return _CARD_CACHE.get(key)


def cached_cost_card(fn, *args, **kwargs) -> dict:
    """`cost_card` memoised on (fn, arg shapes / dtypes / devices): the
    first call runs `fn` under the counter, every later one is a dict
    lookup.  An unhashable `fn` is not cached."""
    try:
        key = (fn, shape_signature((args, kwargs)))
        hash(key)
    except TypeError:
        return cost_card(fn, *args, **kwargs)
    return cached_card(key, lambda: cost_card(fn, *args, **kwargs))


# ---- the capture window --------------------------------------------------

def stage_wall_from_trace(trace_dir: str) -> Optional[dict]:
    """Per-stage seconds from a capture's Chrome trace: the host
    `repro.<stage>` ranges (category `user_annotation`; their device
    projections, `gpu_user_annotation`, are left out so nothing counts
    twice), summed, from the newest `*.trace.json[.gz]` under `trace_dir`;
    None when no parseable trace exists."""
    paths = sorted(glob.glob(os.path.join(trace_dir, "*.trace.json*")),
                   key=os.path.getmtime)
    if not paths:
        return None
    try:
        opener = gzip.open if paths[-1].endswith(".gz") else open
        with opener(paths[-1], "rt") as f:
            trace = json.load(f)
        walls: dict[str, float] = {}
        for ev in trace.get("traceEvents", []):
            name = ev.get("name", "")
            if (ev.get("ph") == "X" and name.startswith(SPAN_PREFIX)
                    and ev.get("cat") != "gpu_user_annotation"):
                stage = name[len(SPAN_PREFIX):]
                walls[stage] = walls.get(stage, 0.0) + \
                    float(ev.get("dur", 0.0)) / 1e6
        return walls or None
    except (OSError, ValueError):
        return None


@contextlib.contextmanager
def trace_capture(telemetry, label: str = "run") -> Iterator[Any]:
    """Profiler window around a run's launches (opt-in).

    No-op (yields None) unless `telemetry` carries a `trace_dir`.  An
    active window runs `torch.profiler.profile` (CUDA activities too on a
    card), records host `stage()` spans and the device stage times a
    stage-split scan hands over, and on exit exports the Chrome trace and
    emits one `profile` event.  The engines synchronise inside the window
    (each scan segment's read-back, each host round's end), so spans
    cover execution."""
    if telemetry is None or not getattr(telemetry, "trace_dir", None):
        yield None
        return
    tdir = os.path.join(telemetry.trace_dir, telemetry.run_id)
    os.makedirs(tdir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = None
    if not torch.autograd._profiler_enabled():
        # a profiler that already runs is left alone: host spans only
        try:
            prof = torch.profiler.profile(activities=activities)
            prof.__enter__()
        except RuntimeError:
            prof = None
    captured = False
    try:
        with record_spans() as rec:
            yield rec
    finally:
        if prof is not None:
            try:
                prof.__exit__(None, None, None)
                prof.export_chrome_trace(os.path.join(
                    tdir, f"{label}.trace.json"))
                captured = True
            except Exception:
                captured = False
        if rec.device:
            source, walls = "graph_events", dict(rec.device)
        else:
            walls = stage_wall_from_trace(tdir) if captured else None
            source = "trace" if walls else "host"
            walls = walls or rec.totals()
        telemetry.emit("profile", trace_dir=tdir, label=label,
                       captured=captured, source=source,
                       stage_wall_s=walls)
