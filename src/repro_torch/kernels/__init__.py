"""Kernel layer of the port (counterpart of `repro/kernels/__init__.py`).

Routing: an ops wrapper sends a CUDA tensor to its hand-written Hopper
kernel (`kernel.py`, CUDA C++ under `csrc/`) and a CPU tensor to its plain
PyTorch version (`ref.py`).  A `meta` tensor takes the kernel's route too,
up to the launch: the wrapper returns empty `meta` outputs of the kernel's
shapes and computes nothing (a dry run counts the step, `launch/dryrun.py`).
There is no other path: a failed build or launch raises, and no wrapper
falls back to the plain version on the card.

Cost counting: each wrapper runs under `counted(name, **shapes)`, which
adds the kernel's formula (`launch/roofline.py::kernel_cost`) to the
innermost active `launch.compat.Count` and mutes the aten ops the wrapper
runs, on every route; with no Count active it does nothing.

Launch counters: `LAUNCHES[name]` is a plain int that a kernel's launcher
bumps once per launch, and nothing else touches, so a run can show that
its main path went through the kernels.  `reset_launches()` zeroes them.

Build: `library()` compiles every `csrc/*.cu` for sm_90a at first use (one
nvcc per source, all started together, then one link) into a shared
library under `_build/` with a plain C interface, and loads it with
ctypes.  The library's file name carries a hash of the sources and flags,
so an edited source never loads a stale build.
"""
from __future__ import annotations

import array
import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import NamedTuple

import torch
import torch.nn.functional as F

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "_build"
# no --use_fast_math: the kernels keep IEEE division, expf and logf
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v")

LAUNCHES = {"prefix_avg": 0, "ce_loss": 0, "cohort_gather": 0,
            "cohort_gather_shard": 0, "delta_codec": 0, "weighted_avg": 0,
            "flash_attention": 0, "flash_attention_bwd": 0,
            "flash_attention_wide": 0, "flash_attention_wide_bwd": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# the active `launch.compat.Count` modes, innermost last
COUNTERS: list = []


@contextlib.contextmanager
def counted(name: str, **shapes):
    """Count one call of kernel `name` by its formula in the innermost
    active Count, its wrapper's aten ops muted; a no-op when none is
    active, and inside another kernel's muted wrapper."""
    if not COUNTERS or COUNTERS[-1].muted:
        yield
        return
    from repro_torch.launch.roofline import kernel_cost
    count = COUNTERS[-1]
    count.kernel(name, *kernel_cost(name, **shapes))
    with count.mute():
        yield


def pad_to(x: torch.Tensor, mult: int) -> torch.Tensor:
    """Zero-pad the last axis of a (M, D) matrix view up to a multiple of
    `mult` (the reference's helper; the CUDA kernels mask ragged edges
    instead of padding)."""
    pad = (-x.shape[-1]) % mult
    return F.pad(x, (0, pad)) if pad else x


def use_kernel(x: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel) and a meta tensor (the
    kernel's shapes, nothing launched), False for a CPU tensor (run the
    plain version); any other device raises."""
    if x.device.type in ("cuda", "meta"):
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"no kernel route for device {x.device}")


# --------------------------------------------------------------------------
# build + load
# --------------------------------------------------------------------------

class Build(NamedTuple):
    path: Path
    seconds: float      # nvcc wall time; 0.0 when the library was cached
    log: str            # nvcc's output (ptxas register / spill report)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    for cand in (os.environ.get("NVCC"),
                 CUDA_HOME and os.path.join(CUDA_HOME, "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or NVCC, or put nvcc "
                       "on PATH")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> Build:
    """Compile `csrc/*.cu` into `_build/` unless this exact build exists."""
    target = BUILD_DIR / f"repro_torch_kernels-{_digest()}.so"
    if target.exists():
        return Build(target, 0.0, "")
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in _sources():
            obj = os.path.join(tmp, src.stem + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", obj],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs, failed = [], []
        for src, proc in procs:
            out, _ = proc.communicate()
            logs.append(f"--- {src.name}\n{out}")
            if proc.returncode:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
        lib = os.path.join(tmp, target.name)
        link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", *objs, "-o", lib],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(lib, target)    # atomic: concurrent builds are safe
    return Build(target, time.perf_counter() - t0, "\n".join(logs))


_PTR, _I64, _F32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float
# C entry points: each takes device pointers (cohort_gather, delta_codec,
# prefix_avg and weighted_avg a host table of leaves, passed to the kernel
# by value), sizes, the device index and the stream, and returns
# cudaGetLastError() after its launch (or the error of a check that
# refused it)
_SIGNATURES = {
    # (leaf table, leaves, perms, n_k, R, M, walks, blocks, device, stream)
    "prefix_avg_f32": [_PTR, _I64, _PTR, _PTR] + [_I64] * 5 + [_PTR],
    "prefix_avg_bf16": [_PTR, _I64, _PTR, _PTR] + [_I64] * 5 + [_PTR],
    "ce_loss_f32": [_PTR] * 3 + [_I64] * 6 + [_PTR],
    "ce_loss_bf16": [_PTR] * 3 + [_I64] * 6 + [_PTR],
    # (leaf table, leaves, host ids, M, blocks, device, stream)
    "cohort_gather": [_PTR, _I64, _PTR] + [_I64] * 3 + [_PTR],
    # (leaf table, leaves, device ids, M, blocks, error word, device, stream)
    "cohort_gather_ids": [_PTR, _I64, _PTR, _I64, _I64, _PTR, _I64, _PTR],
    # (leaf table, leaves, device ids, M, blocks, lo, N, error word, device,
    # stream)
    "cohort_gather_shard": [_PTR, _I64, _PTR, _I64, _I64, _I64, _I64, _PTR,
                            _I64, _PTR],
    # (leaf table, leaves, rows, codec, shared memory, device, stream)
    "delta_codec_f32": [_PTR] + [_I64] * 5 + [_PTR],
    # (shared memory, device, out: clusters)
    "delta_codec_occupancy": [_I64, _I64, _PTR],
    # (leaf table, leaves, weights, R, M, rows, blocks, device, stream)
    "weighted_avg_f32": [_PTR, _I64, _PTR] + [_I64] * 5 + [_PTR],
    "weighted_avg_bf16": [_PTR, _I64, _PTR] + [_I64] * 5 + [_PTR],
    # (q, k, v, o, lse or null, q_pos, sizes, strides, causal, window,
    # scale, device, stream)
    "flash_attention_f32": [_PTR] * 6 + [_I64] * 20 + [_F32, _I64, _PTR],
    "flash_attention_bf16": [_PTR] * 6 + [_I64] * 20 + [_F32, _I64, _PTR],
    # (q, k, v, o, dO, lse, q_pos, dq, dk, dv, rows, bounds, part or null,
    # B, S, T, Hq, Kh, hd, the (b, s, h) strides of q, k, v, o and dO,
    # causal, window, scale, device, stream)
    "flash_attention_bwd_f32": [_PTR] * 13 + [_I64] * 23 + [_F32, _I64,
                                                            _PTR],
    "flash_attention_bwd_bf16": [_PTR] * 13 + [_I64] * 23 + [_F32, _I64,
                                                             _PTR],
    # head dims above 128: the forward's arguments; the backward's without
    # the bounds scratch (rows: the (B, Hq, S) f32 D)
    "flash_attention_wide_f32": [_PTR] * 6 + [_I64] * 20 + [_F32, _I64, _PTR],
    "flash_attention_wide_bf16": [_PTR] * 6 + [_I64] * 20 + [_F32, _I64,
                                                             _PTR],
    "flash_attention_wide_bwd_f32": [_PTR] * 11 + [_I64] * 23 + [_F32, _I64,
                                                                 _PTR],
    "flash_attention_wide_bwd_bf16": [_PTR] * 11 + [_I64] * 23 + [_F32, _I64,
                                                                  _PTR],
    # conditional nodes (engine/graph_flow.py): (out: runtime, driver);
    # (device, out: stream); (flag, kind, mode, device, stream, body
    # stream, out: body graph, handle); (handle, flag or null, device,
    # body stream)
    "graph_cond_versions": [_PTR],
    "graph_cond_stream": [_I64, _PTR],
    "graph_cond_begin": [_PTR] + [_I64] * 3 + [_PTR] * 3,
    "graph_cond_end": [_I64, _PTR, _I64, _PTR],
}

_lib = None
_lib_lock = threading.Lock()


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use (the build's seconds
    go to every active `telemetry.CompileTimer`)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            from repro_torch.telemetry.trace import add_compile_seconds
            b = build()
            add_compile_seconds(b.seconds)
            lib = ctypes.CDLL(str(b.path))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check_launch(rc: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def host_table(values: list[int]) -> ctypes.Array:
    """int64 values in host memory as a ctypes array: a pointer argument of
    a C entry that keeps its memory alive through the call (the kernels
    that take a table of leaves copy it into their parameters)."""
    buf = array.array("q", values)
    return (ctypes.c_int64 * len(buf)).from_buffer(buf)


def stream_ptr(x: torch.Tensor) -> int:
    """PyTorch's current stream on `x`'s device, as a raw handle."""
    return torch.cuda.current_stream(x.device).cuda_stream
