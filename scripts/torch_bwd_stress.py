#!/usr/bin/env python3
"""Looks for memory that flash_attention's backward reads before writing.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 scripts/torch_bwd_stress.py [--procs N] [--repeats R]
        [--out FILE]

For each case (default: Hymba-1.5B's heads, B 1, S = T = 1300, Hq 25, Kh 5,
hd 64, causal, window 1024, f32 and bf16, on the inputs of
`tests/test_torch_gpu.py::test_flash_attention_bwd_kernel_matches_plain`;
and phase 20's layer, B 4, S 2048) it calls `flash_attention_bwd_cuda`
`--repeats` times under each of these poisons and compares every output bit
for bit with the clean call's, and dq / dk / dv with the plain version
(`attention_bwd_gqa_ref`, f32, on the CPU; f32 at the gpu test's rule,
|err| <= 2e-5 max |grad|, bf16 at its departure rule; a NaN counts as
over the limit):

    clean      nothing
    allocator  the caching allocator's free blocks, large and small, filled
               with NaN just before the call
    empty      `torch.empty` returns NaN (float) or 0x7fffffff (int32)
               tensors during the call: the rows and bounds scratch and
               dq / dk / dv
    margins    q, k, v, o, dO and lse as views into NaN storage, 4 KiB of
               NaN before and after each
    smem       the same backward first launched on NaN inputs, which leaves
               NaN in the shared memory its kernels use on every SM
    all        all of the above at once

With `--procs N` it then runs the pytest selection `-k "moe or ssm or
1300"` of `tests/test_torch_gpu.py` N times, each in a fresh process, and
counts the runs that pass; every second run shares the card with a
process that multiplies bf16 matrices the whole time, which changes the
kernels' timing.  `--repeats 0` skips the poisoned calls.  Prints one
line a case and poison, and a JSON summary as its last line (the whole
record also to `--out`).  Exits non-zero without a card, and when any
poisoned call differs from the clean one, any call fails the plain
version's bound or any run of the selection fails.
"""
from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
POISONS = ("clean", "allocator", "empty", "margins", "smem", "all")
# (label, B, S, T, Hq, Kh, hd, window): the first is the gpu test's case
CASES = (("test 1300", 1, 1300, 1300, 25, 5, 64, 1024),
         ("Hymba layer", 4, 2048, 2048, 25, 5, 64, 1024))


def inputs(torch, device, dtype, b, s, t, hq, kh, hd, win):
    """The gpu test's `_bwd_case` draws (seed s + t + hd), the forward
    kernel's o and lse, and the positions."""
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_cuda,
    )
    seed = s + t + hd
    gen = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=gen).to(device, dtype)
               for shape in ((b, s, hq, hd), (b, t, kh, hd), (b, t, kh, hd)))
    pos = torch.arange(s, device=device)
    o, lse = flash_attention_cuda(q, k, v, pos, window=win, with_lse=True)
    do = torch.randn(o.shape, generator=torch.Generator().manual_seed(
        seed + 1)).to(device, dtype)
    return q, k, v, o, do, lse, pos


def poison_allocator(torch, device):
    """Fill the caching allocator's free memory with NaN: one large block
    of most of what is free, and 2 MB of small blocks."""
    free, _ = torch.cuda.mem_get_info(device)
    big = torch.full((int(free * 0.8) // 4,), float("nan"), device=device)
    small = [torch.full((4096,), float("nan"), device=device)
             for _ in range(512)]
    torch.cuda.synchronize()
    del big, small


@contextlib.contextmanager
def poison_empty(torch):
    real = torch.empty

    def empty(*args, **kw):
        t = real(*args, **kw)
        if t.is_floating_point():
            t.fill_(float("nan"))
        elif t.dtype == torch.int32:
            t.fill_(0x7FFFFFFF)
        return t

    torch.empty = empty
    try:
        yield
    finally:
        torch.empty = real


def in_margins(torch, x, pad=4096):
    """x as a view into NaN storage with `pad` bytes before and after."""
    n, p = x.numel(), pad // x.element_size()
    store = torch.full((n + 2 * p,), float("nan"), dtype=x.dtype,
                       device=x.device)
    view = store[p:p + n].view(x.shape)
    view.copy_(x)
    return view


def digest(torch, tensors) -> str:
    """sha256 of the tensors' bytes (first 16 hex digits)."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().view(-1).view(torch.uint8).cpu().numpy()
                 .tobytes())
    return h.hexdigest()[:16]


def plain(args, win):
    """`attention_bwd_gqa_ref` on the CPU in f32, of the same inputs."""
    from repro_torch.kernels.flash_attention import attention_bwd_gqa_ref
    q, k, v, o, do, lse, pos = args
    return attention_bwd_gqa_ref(
        *(x.cpu().float() for x in (q, k, v, o, do)), lse.cpu(),
        q_pos=pos.cpu(), causal=True, window=win)


def against_plain(torch, got, want):
    """Elements over |err| <= rtol |grad| + atol max |grad|, NaN counted
    over, and the worst share of the limit.  f32: rtol 0, atol 2e-5, the
    gpu test's rule.  bf16 against the exact plain version: rtol 2^-7,
    atol 2^-8, the test's departure rule."""
    bf16 = got[0].dtype == torch.bfloat16
    rtol, atol = (2.0 ** -7, 2.0 ** -8) if bf16 else (0.0, 2e-5)
    out = {}
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        g = g.cpu().float()
        err = (g - w).abs()
        limit = rtol * w.abs() + atol * float(w.abs().max())
        bad = ~(err <= limit)
        out[name] = {"over": int(bad.sum()),
                     "nan": int(torch.isnan(g).sum()),
                     "share": float((err / limit.clamp_min(1e-30))
                                    .nan_to_num(nan=float("inf")).max())}
    return out


def run_case(torch, device, label, dtype, shape, repeats):
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_bwd_cuda,
    )
    b, s, t, hq, kh, hd, win = shape
    args = inputs(torch, device, dtype, b, s, t, hq, kh, hd, win)
    q, k, v, o, do, lse, pos = args
    nan_args = [torch.full_like(x, float("nan")) for x in (q, k, v, o, do)]
    nan_lse = torch.full_like(lse, float("nan"))
    want = plain(args, win)
    rows, clean, ok = [], None, True
    for poison in POISONS:
        on = {poison} if poison != "all" else set(POISONS)
        use = args
        if "margins" in on:
            use = (*(in_margins(torch, x) for x in (q, k, v, o, do, lse)),
                   pos)
        digests, checks = set(), []
        for _ in range(repeats):
            if "smem" in on:
                flash_attention_bwd_cuda(*nan_args, nan_lse, pos,
                                         window=win)
            if "allocator" in on:
                poison_allocator(torch, device)
            with (poison_empty(torch) if "empty" in on
                  else contextlib.nullcontext()):
                got = flash_attention_bwd_cuda(*use[:6], use[6], window=win)
            torch.cuda.synchronize()
            digests.add(digest(torch, got))
            checks.append(against_plain(torch, got, want))
            del got
        if clean is None:
            clean = digests
        same = digests == clean
        over = max(c[n]["over"] for c in checks for n in c)
        share = max(c[n]["share"] for c in checks for n in c)
        nans = max(c[n]["nan"] for c in checks for n in c)
        ok &= same and over == 0
        rows.append({"case": label, "dtype": str(dtype)[6:],
                     "poison": poison, "repeats": repeats,
                     "outputs": sorted(digests), "bitwise_clean": same,
                     "over_limit": over, "nan": nans,
                     "worst_share": share})
        print(f"[stress] {label} {str(dtype)[6:]} {poison}: {repeats} calls, "
              f"outputs {sorted(digests)} (bitwise the clean call's: {same}),"
              f" elements over the limit {over}, NaN {nans}, worst share "
              f"of the limit {share:.3f}", flush=True)
    return rows, ok


LOAD = ("import time, torch\n"
        "a = torch.randn(8192, 8192, device='cuda', dtype=torch.bfloat16)\n"
        "t = time.time()\n"
        "while time.time() - t < 120:\n"
        "    a = (a @ a).clamp_(-1, 1)\n")


def run_procs(n):
    """The selection `-k "moe or ssm or 1300"`, each run in a fresh
    process; odd runs beside a process that loads the card."""
    cmd = [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
           "--noconftest", "tests/test_torch_gpu.py", "-k",
           "moe or ssm or 1300"]
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    results = []
    for i in range(n):
        t0 = time.perf_counter()
        load = (subprocess.Popen([sys.executable, "-c", LOAD], env=env)
                if i % 2 else None)
        try:
            p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                               timeout=600, env=env)
        finally:
            if load is not None:
                load.kill()
                load.wait()
        tail = p.stdout.strip().splitlines()[-1] if p.stdout.strip() else ""
        failed = [ln for ln in p.stdout.splitlines()
                  if ln.startswith("FAILED")]
        results.append({"rc": p.returncode, "summary": tail,
                        "failed": failed, "loaded": load is not None})
        print(f"[procs] run {i} (card loaded: {load is not None}): rc "
              f"{p.returncode}, {tail} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        for ln in failed:
            print(f"[procs]   {ln}", flush=True)
        if p.returncode:
            print(p.stdout[-4000:], flush=True)
    return results


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--procs", type=int, default=0)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_bwd_stress: no CUDA device is available",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    from repro_torch.device import resolve_device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(f"[env] torch {torch.__version__}; {smi}", flush=True)
    build()
    device = resolve_device("cuda")
    rows, ok = [], True
    for label, *shape in CASES if args.repeats else ():
        for dtype in (torch.float32, torch.bfloat16):
            r, good = run_case(torch, device, label, dtype, shape,
                               args.repeats)
            rows += r
            ok &= good
            torch.cuda.empty_cache()
    procs = run_procs(args.procs) if args.procs else []
    ok &= all(p["rc"] == 0 for p in procs)
    summary = {"device": smi, "ok": ok, "calls": rows, "procs": procs}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(summary, indent=1))
    print(json.dumps({"ok": ok, "procs_passed": sum(
        p["rc"] == 0 for p in procs), "procs": len(procs), "calls_bitwise":
        all(r["bitwise_clean"] for r in rows)}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
