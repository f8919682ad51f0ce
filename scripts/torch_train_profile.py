#!/usr/bin/env python3
"""Where an LM train step's time goes on the card.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 scripts/torch_train_profile.py [--steps 3] [--out FILE]
                                           [--src DIR] [--label NAME]

Trains full-width TinyLlama-1.1B (bf16 activations, f32 params, AdamW,
per-layer remat, random weights from a seed) on one fixed B = 4 x S =
2048 batch through `repro_torch.launch.train`'s LM-mode functions, as
`chip_smoke.py` phase 15 does, after two warm-up steps:

1. `--steps` step times on the host clock after a device synchronise,
   without the profiler;
2. torch.profiler over one step: the device busy share (a lower bound:
   the profiler's host cost lengthens the step), the kernels that take the
   most device time grouped by name, and their sums by kind (the flash
   forward and backward kernels, matrix products, the rest).

`--src` runs the port under another directory (a `git archive` of another
version's `src`), so that two versions can be profiled in turns in one
call.  Exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# kernel-name patterns of each kind, tried in this order
KINDS = (("flash_attention_bwd", ("bwd_delta_kernel", "bwd_rows_kernel",
                                  "bwd_dkdv", "bwd_dq")),
         ("flash_attention", ("flash_tc_kernel", "flash_f32_tc_kernel")),
         ("matmul", ("gemm", "xmma", "cutlass", "nvjet")))


def kind_of(name: str) -> str:
    for kind, pats in KINDS:
        if any(p in name for p in pats):
            return kind
    return "other"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--out", default=None, help="write the results as JSON")
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="this checkout")
    args = ap.parse_args()
    import subprocess
    import torch
    if not torch.cuda.is_available():
        print("torch_train_profile: no CUDA device is available",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve()))
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.launch.train import build_lm, synth_batch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(f"[env] {args.label}: torch {torch.__version__}; {smi}")
    cfg = get_config("tinyllama_1_1b")
    b, s_len = 4, 2048
    params, opt, step, gen = build_lm(cfg, 0, "cuda")
    batch = synth_batch(cfg, gen, b, s_len)
    state = {"params": params, "opt": opt}

    def one_step():
        state["params"], state["opt"], m = step(state["params"],
                                                state["opt"], batch)
        return m

    for _ in range(2):
        one_step()
    times = []
    for _ in range(args.steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one_step()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    print(f"[train] {args.label}: {cfg.name}, B={b}, S={s_len}: ms a step "
          f"{[round(t, 3) for t in times]} (no profiler)")

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        one_step()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in events) / 1e3
    if not dev_ms:
        raise RuntimeError("the profiler saw no device time: the busy share "
                           "is not measured")
    by_kind: dict = {}
    for e in events:
        k = kind_of(e.key)
        ms, n = by_kind.get(k, (0.0, 0))
        by_kind[k] = (ms + e.self_device_time_total / 1e3, n + e.count)
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:15]
    print(f"[profile] {args.label}: one step: wall {wall_ms:.2f} ms (profiled), device "
          f"{dev_ms:.2f} ms -> busy {100 * dev_ms / wall_ms:.1f}%")
    for k, (ms, n) in sorted(by_kind.items(), key=lambda kv: -kv[1][0]):
        print(f"[profile] {args.label}: by kind: {k:20s} {ms:10.3f} ms "
              f"({100 * ms / dev_ms:5.1f}% of device time), {n} launches")
    for e in top:
        print(f"[profile]   {e.self_device_time_total / 1e3:10.3f} ms  "
              f"x{e.count:<6d} {e.key[:100]}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({
            "label": args.label, "device": smi, "arch": cfg.name, "batch": b, "seq": s_len,
            "step_ms": times, "profiled_wall_ms": wall_ms,
            "device_ms": dev_ms,
            "by_kind": {k: {"ms": ms, "launches": n}
                        for k, (ms, n) in by_kind.items()},
            "top": [(e.key[:100], e.self_device_time_total / 1e3, e.count)
                    for e in top]}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
