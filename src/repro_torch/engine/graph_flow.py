"""Data-dependent control flow that a captured CUDA graph holds: the
port's counterpart of the `lax.while_loop` and `lax.cond` that the
reference runs inside its scan (the serial GTG-Shapley estimator,
`core/shapley.py::gtg_shapley_device`).

    while_(cond, body, state, max_passes)  body() while the () bool cond
    if_(pred, body, outs)                  body() if the () bool pred

Both take device tensors and read nothing back.  While the current
stream is being captured into a CUDA graph, each makes one conditional
node of that graph (`kernels/csrc/graph_cond.cu`, CUDA 12.4+): a kernel
just before the node sets its condition from the flag, the body is
captured into the node's own graph on a stream of its own, and a WHILE
body ends with a kernel that sets the condition again from the flag the
body rewrote.  A WHILE whose flag is false before its first pass runs no
pass.  `NODES` counts the nodes the entry made, and `WHILE_BODIES` the
conditional nodes it made inside each WHILE body.

Everywhere else (the CPU, and an eager pass on the card such as the
warm-up before a capture) they run a masked unroll: `while_` runs
`max_passes` passes and `if_` its body once, every step evaluated, and a
`torch.where` on the flag keeps or discards what the body wrote.  Same
values, no host read; only the time differs.  `eager_passes(n)` caps the
unroll (a warm-up needs one pass to meet every op).  On the card the
eager bodies run on the streams their capture will use.

What a body may do, since a conditional node holds it:
  (a) write its results in place (`copy_`) into tensors allocated before
      the node (`outs`, `state`): an out-of-place result is a new address
      that the code after the node, or the next pass, never reads;
  (b) allocate: the allocations of a body come from the capture's memory
      pool, which `capture_pool(pool)` names (the capture's own routing
      sees only its own stream, so each node routes this thread's
      allocations to the pool instead, until the capture ends);
  (c) launch kernels, memsets and device-to-device copies only: no host
      node, no event (so no CUDA timing event and no `named_stage`
      boundary of a stage-timed capture inside it), no host read.
"""
from __future__ import annotations

import contextlib
import ctypes
from typing import Callable, Iterator, Optional, Sequence

import torch

from repro_torch import kernels

IF, WHILE = 0, 1
MIN_CUDA = 12040             # conditional nodes: CUDA 12.4
CAPTURE_MODE = 0             # cudaStreamCaptureModeGlobal, torch's default
THREAD_LOCAL_MODE = 1        # cudaStreamCaptureModeThreadLocal

NODES = {"while": 0, "if": 0}
WHILE_BODIES: list = []      # conditional nodes made in each WHILE body

_pool = None                 # memory pool of the capture in progress
_mode = CAPTURE_MODE         # its capture mode
_eager_passes: Optional[int] = None
_depth = 0                   # nesting depth of the body being captured
_inside: list = []           # nodes made in each body being captured
_streams: dict = {}          # (device index, depth) -> body stream
_versions: dict = {}         # device index -> (runtime, driver)


def depth() -> int:
    """How many conditional bodies enclose the code running now (captured,
    or the masked unroll's eager passes); 0 outside them."""
    return _depth


def reset_nodes() -> None:
    NODES["while"] = NODES["if"] = 0
    WHILE_BODIES.clear()


@contextlib.contextmanager
def capture_pool(pool, *, thread_local: bool = False) -> Iterator[None]:
    """Name the memory pool of the graph captured inside the block (the
    `pool=` given to `torch.cuda.graph` or `CUDAGraph.capture_begin`), and
    its capture mode: the bodies are captured in the graph's own mode
    (`thread_local=True` for a graph captured with
    `capture_error_mode="thread_local"`, as a round holding NCCL
    collectives is)."""
    global _pool, _mode
    previous = _pool, _mode
    _pool, _mode = pool, THREAD_LOCAL_MODE if thread_local else CAPTURE_MODE
    try:
        yield
    finally:
        _pool, _mode = previous


@contextlib.contextmanager
def eager_passes(n: int) -> Iterator[None]:
    """Cap the masked unroll of `while_` at n passes inside the block."""
    global _eager_passes
    previous, _eager_passes = _eager_passes, n
    try:
        yield
    finally:
        _eager_passes = previous


def _index(device: torch.device) -> int:
    return (device.index if device.index is not None
            else torch.cuda.current_device())


def check_versions(device) -> tuple[int, int]:
    """The CUDA runtime and driver versions behind the conditional-node
    entry (and PyTorch's runtime, which captures the graph); raises unless
    all are 12.4 or newer."""
    idx = _index(torch.device(device))
    if idx not in _versions:
        out = (ctypes.c_int64 * 2)()
        kernels.check_launch(kernels.library().graph_cond_versions(out),
                             "graph_cond_versions")
        major, minor = (int(v) for v in torch.version.cuda.split(".")[:2])
        found = {"runtime": out[0], "driver": out[1],
                 "torch's runtime": 1000 * major + 10 * minor}
        old = {k: v for k, v in found.items() if v < MIN_CUDA}
        if old:
            raise RuntimeError(f"CUDA-graph conditional nodes need CUDA 12.4 "
                               f"or newer; found {found}")
        _versions[idx] = (int(out[0]), int(out[1]))
    return _versions[idx]


def _body_stream(device: torch.device, depth: int):
    """The stream a body at nesting `depth` runs on: one a device and
    depth, made by the entry, never one of PyTorch's pooled streams (which
    a capture may be using)."""
    key = (_index(device), depth)
    if key not in _streams:
        ptr = ctypes.c_void_p()
        kernels.check_launch(kernels.library().graph_cond_stream(
            key[0], ctypes.byref(ptr)), "graph_cond_stream")
        _streams[key] = torch.cuda.ExternalStream(ptr.value, device=device)
    return _streams[key]


def _capturing(flag: torch.Tensor) -> bool:
    return flag.is_cuda and torch.cuda.is_current_stream_capturing()


def _check_flag(flag: torch.Tensor) -> None:
    if flag.dtype != torch.bool or flag.dim() != 0:
        raise ValueError(f"a condition is a () bool tensor, got "
                         f"{flag.dtype} {tuple(flag.shape)}")


def _route_to_pool(idx: int) -> None:
    """Route this thread's allocations to the capture's pool: the
    allocator keeps one routing entry a pool, so the capture's own entry
    (its stream only) is ended first; the release balances the pool's use
    count, which the new entry raised."""
    torch._C._cuda_endAllocateToPool(idx, _pool)
    torch._C._cuda_beginAllocateCurrentThreadToPool(idx, _pool)
    torch._C._cuda_releasePool(idx, _pool)


def _node(kind: int, flag: torch.Tensor, body: Callable[[], None]) -> None:
    """One conditional node in the graph being captured, its body
    captured into the node's graph."""
    global _depth
    if _pool is None:
        raise RuntimeError("a conditional node needs its capture's memory "
                           "pool: capture under graph_flow.capture_pool()")
    device = flag.device
    check_versions(device)
    idx = _index(device)
    lib = kernels.library()
    parent = torch.cuda.current_stream(device)
    child = _body_stream(device, _depth)
    made = (ctypes.c_int64 * 2)()
    kernels.check_launch(lib.graph_cond_begin(
        flag.data_ptr(), kind, _mode, idx, parent.cuda_stream,
        child.cuda_stream, made), "graph_cond_begin")
    NODES["while" if kind == WHILE else "if"] += 1
    if _inside:
        _inside[-1] += 1
    _route_to_pool(idx)
    _depth += 1
    _inside.append(0)
    try:
        with torch.cuda.stream(child):
            body()
    finally:
        _depth -= 1
        inner = _inside.pop()
        rc = lib.graph_cond_end(made[1], flag.data_ptr() if kind == WHILE
                                else None, idx, child.cuda_stream)
    kernels.check_launch(rc, "graph_cond_end")
    if kind == WHILE:
        WHILE_BODIES.append(inner)


@contextlib.contextmanager
def _eager_body(device: torch.device) -> Iterator[None]:
    """An eager body on the card runs on the stream its capture will use,
    so that stream's library state (cuBLAS's workspace) exists before."""
    global _depth
    if device.type != "cuda":
        _depth += 1
        try:
            yield
        finally:
            _depth -= 1
        return
    parent = torch.cuda.current_stream(device)
    child = _body_stream(device, _depth)
    child.wait_stream(parent)
    _depth += 1
    try:
        with torch.cuda.stream(child):
            yield
    finally:
        _depth -= 1
        parent.wait_stream(child)


def while_(cond: torch.Tensor, body: Callable[[], None],
           state: Sequence[torch.Tensor], max_passes: int) -> None:
    """Run `body` while the () bool `cond` holds.  The body rewrites
    `cond` and the loop carry `state` in place, and must make `cond` false
    within `max_passes` passes (the masked unroll runs that many)."""
    _check_flag(cond)
    if _capturing(cond):
        _node(WHILE, cond, body)
        return
    passes = max_passes if _eager_passes is None else min(max_passes,
                                                          _eager_passes)
    for _ in range(passes):
        live = cond.clone()
        before = [s.clone() for s in state]
        with _eager_body(cond.device):
            body()
        for s, old in zip(state, before):
            s.copy_(torch.where(live, s, old))
        cond.logical_and_(live)


def if_(pred: torch.Tensor, body: Callable[[], None],
        outs: Sequence[torch.Tensor]) -> None:
    """Run `body` if the () bool `pred` holds; the body writes `outs` in
    place, and they keep their values where it does not run."""
    _check_flag(pred)
    if _capturing(pred):
        _node(IF, pred, body)
        return
    before = [o.clone() for o in outs]
    with _eager_body(pred.device):
        body()
    for o, old in zip(outs, before):
        o.copy_(torch.where(pred, o, old))
