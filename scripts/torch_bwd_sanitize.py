#!/usr/bin/env python3
"""Runs flash_attention's backward under NVIDIA's compute-sanitizer.

Run from the root of a checkout, on a machine with one CUDA card and the
CUDA toolkit's `compute-sanitizer`:

    python3 scripts/torch_bwd_sanitize.py [--tools racecheck,synccheck,...]
        [--dtypes f32,bf16] [--timeout SECONDS] [--out FILE]

The case is the G = 5 shape of `tests/test_torch_gpu.py::
test_flash_attention_bwd_kernel_matches_plain` (Hymba-1.5B's heads: B 1,
S = T = 1300, Hq 25, Kh 5, hd 64, causal, window 1024) on that test's
draws, f32 and bf16.  For each tool and dtype a child process (`--child`)
runs under `compute-sanitizer --tool TOOL --kernel-name kns=bwd_`, so only
the backward's three kernels are checked:

    memcheck   out-of-bounds and misaligned device and shared accesses
    racecheck  shared-memory hazards between threads, whatever the timing
    synccheck  barriers misused (divergent or mismatched __syncthreads,
               named barriers, warp syncs)
    initcheck  device memory read before anything wrote it

The child copies every input to the card from host memory (so each is
written before the call; o and lse come from the forward kernel, read back
and copied again) and runs with PYTORCH_NO_CUDA_MEMORY_CACHING=1, so each
of the wrapper's `torch.empty` buffers is its own allocation.  The parent
builds the kernel library first, then starts every child at once.  Prints
one line a tool and dtype (exit code, seconds, the sanitizer's summary)
and a JSON summary last (the whole record also to `--out`).  Exits
non-zero when the sanitizer is missing, a run fails or times out, or a
tool reports an error.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TOOLS = ("memcheck", "racecheck", "synccheck", "initcheck")
CASE = dict(b=1, s=1300, t=1300, hq=25, kh=5, hd=64, window=1024)


def child(dtype_name: str) -> int:
    """One backward call on host-written inputs, synchronised."""
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_bwd_cuda, flash_attention_cuda,
    )
    dtype = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype_name]
    c, dev = CASE, torch.device("cuda")
    seed = c["s"] + c["t"] + c["hd"]
    gen = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=gen).to(dtype).to(dev)
               for shape in ((c["b"], c["s"], c["hq"], c["hd"]),
                             (c["b"], c["t"], c["kh"], c["hd"]),
                             (c["b"], c["t"], c["kh"], c["hd"])))
    pos = torch.arange(c["s"]).to(dev)
    o, lse = flash_attention_cuda(q, k, v, pos, window=c["window"],
                                  with_lse=True)
    o, lse = o.cpu().to(dev), lse.cpu().to(dev)
    do = torch.randn(tuple(o.shape), generator=torch.Generator().manual_seed(
        seed + 1)).to(dtype).to(dev)
    torch.cuda.synchronize()
    dq, dk, dv = flash_attention_bwd_cuda(q, k, v, o, do, lse, pos,
                                          window=c["window"])
    torch.cuda.synchronize()
    finite = all(bool(torch.isfinite(x.float()).all()) for x in (dq, dk, dv))
    print(f"child {dtype_name}: finite {finite}")
    return 0 if finite else 1


def summary_line(text: str) -> str:
    lines = [ln for ln in text.splitlines() if "ERROR SUMMARY" in ln
             or "RACECHECK SUMMARY" in ln]
    return lines[-1].strip() if lines else ""


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tools", default=",".join(TOOLS))
    ap.add_argument("--dtypes", default="f32,bf16")
    ap.add_argument("--timeout", type=float, default=420.0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--child", default=None)
    args = ap.parse_args()
    if args.child:
        return child(args.child)

    import torch
    if not torch.cuda.is_available():
        print("torch_bwd_sanitize: no CUDA device", file=sys.stderr)
        return 1
    sanitizer = (shutil.which("compute-sanitizer")
                 or next((p for p in ("/usr/local/cuda/bin/compute-sanitizer",)
                          if os.path.exists(p)), None))
    if sanitizer is None:
        print("torch_bwd_sanitize: compute-sanitizer not found",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import kernels
    kernels.library()                   # build once, outside the tools
    env = dict(os.environ, PYTORCH_NO_CUDA_MEMORY_CACHING="1")
    runs = []
    for tool in args.tools.split(","):
        for dt in args.dtypes.split(","):
            cmd = [sanitizer, "--tool", tool, "--kernel-name", "kns=bwd_",
                   "--error-exitcode", "99", "--print-limit", "20",
                   sys.executable, str(Path(__file__).resolve()),
                   "--child", dt]
            runs.append((tool, dt, time.perf_counter(), subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True, env=env)))
    record, bad = [], False
    for tool, dt, t0, proc in runs:
        left = max(1.0, args.timeout - (time.perf_counter() - t0))
        try:
            out, _ = proc.communicate(timeout=left)
            rc = proc.returncode
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
            rc = "timeout"
        secs = time.perf_counter() - t0
        summ = summary_line(out)
        ok = rc == 0 and f"child {dt}: finite True" in out
        bad |= not ok
        print(f"[sanitize] {tool:9s} {dt:4s} rc {rc} {secs:7.1f} s "
              f"{summ or '(no summary)'}")
        if not ok:
            print("\n".join(out.splitlines()[-40:]))
        record.append({"tool": tool, "dtype": dt, "rc": rc,
                       "seconds": round(secs, 1), "summary": summ,
                       "ok": ok, "tail": out.splitlines()[-40:]})
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(record, indent=1))
    print(json.dumps({"case": CASE, "runs": [
        {k: r[k] for k in ("tool", "dtype", "rc", "seconds", "summary",
                           "ok")} for r in record]}))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
