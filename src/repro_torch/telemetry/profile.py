"""Device-cost profiling: per-step cost cards and the capture window
(counterpart of `repro/telemetry/profile.py`).

  * `cost_card(fn, *args)`: one eager run of `fn` under
    `launch.compat.Count` gives `flops` (the matrix products by
    `torch.utils.flop_counter`'s formulas, and each hand-written kernel by
    its formula, `launch.roofline.kernel_cost`, whichever route ran;
    elementwise work has no FLOPs) and `bytes_accessed` (each op's tensor
    inputs and outputs, each kernel's formula bytes).  `card_of(count)`
    assembles a card from a Count an engine ran itself: the scan counts its
    round body in the eager run it makes anyway (the capture's warm-up on a
    card, the first round on the CPU), its `kernel_launches` are the
    launches its captured round holds, and `peak_bytes` is
    `torch.cuda.max_memory_allocated` above the set-up (None on the CPU).
    The roofline block is the reference's `cost_card_of_compiled`'s at the
    H100's rates (`launch/roofline.py`): `compute_s` sums each op's FLOPs
    over its dtype's peak (float32 on the CUDA cores: the port turns TF32
    off), `memory_s` is `bytes_accessed` over the HBM rate.
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
"""
from __future__ import annotations

import contextlib
import glob
import gzip
import json
import os
from typing import Any, Iterator, Optional

import torch

from repro_torch.launch.compat import Count
from repro_torch.launch.roofline import F32_PEAK_FLOPS, HBM_BYTES_PER_S
from repro_torch.telemetry.trace import SPAN_PREFIX, record_spans

_MODE_READY = False


def prepare_counting() -> None:
    """Pay, once a process, what the first dispatch mode costs (torch
    imports its decomposition tables then: ~2 s on a workstation, ~9 s on
    the card's host), on a CPU scalar and outside any timed window."""
    global _MODE_READY
    if not _MODE_READY:
        with Count():
            torch.zeros(()) + 1
        _MODE_READY = True


def card(flops: Optional[float], *, bytes_accessed: Optional[float] = None,
         compute_s: Optional[float] = None,
         kernel_launches: Optional[dict] = None,
         peak_bytes: Optional[int] = None) -> dict:
    """A cost card from measured counts, with the reference's roofline
    block: compute and memory seconds at the card's rates (`compute_s`
    defaults to `flops` at the float32 peak), the dominant term, the
    arithmetic intensity and the ridge, the intensity at which the two
    terms meet (at the FLOPs' own mix of peaks)."""
    out: dict = {"flops": flops, "bytes_accessed": bytes_accessed,
                 "kernel_launches": kernel_launches,
                 "peak_bytes": peak_bytes}
    if flops is not None and bytes_accessed:
        out["intensity_flops_per_byte"] = flops / bytes_accessed
    if flops is not None or bytes_accessed is not None:
        if compute_s is None:
            compute_s = (flops or 0.0) / F32_PEAK_FLOPS
        memory_s = (bytes_accessed or 0.0) / HBM_BYTES_PER_S
        peak = flops / compute_s if flops and compute_s else F32_PEAK_FLOPS
        out["roofline"] = {
            "compute_s": compute_s,
            "memory_s": memory_s,
            "dominant": "compute" if compute_s >= memory_s else "memory",
            "ridge_intensity_flops_per_byte": peak / HBM_BYTES_PER_S,
        }
    return out


def card_of(count: Count, **kw) -> dict:
    """`card` of a finished `launch.compat.Count`."""
    return card(float(count.flops), bytes_accessed=float(count.bytes),
                compute_s=count.compute_s, **kw)


def cost_card(fn, *args, **kwargs) -> dict:
    """Run `fn(*args, **kwargs)` once, eagerly, under `Count`; the card of
    that run (peak bytes above the start on a card)."""
    cuda = torch.cuda.is_available() and any(
        isinstance(a, torch.Tensor) and a.is_cuda
        for a in _leaves((args, kwargs)))
    if cuda:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    with Count() as c:
        fn(*args, **kwargs)
    peak = None
    if cuda:
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
    return card_of(c, peak_bytes=peak)


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
