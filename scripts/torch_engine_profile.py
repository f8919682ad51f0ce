#!/usr/bin/env python3
"""Where a round's time goes on the card, for the port's two engines.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 scripts/torch_engine_profile.py [--rounds 4] [--out FILE]

1. Local training, one full-width cohort (M = 5 MNIST MLPs, E = B = 5,
   batch 32): CUDA-event times of the loop engine (5 x client_update),
   the batched engine (batched_client_update: per-client autograd graphs,
   stacked update) and a torch.func.vmap-over-grad variant written here
   (one batched GEMM per layer), and the largest gradient difference
   between the per-client and the vmapped gradients of one step.
2. Device busy share: torch.profiler over a full-width GreedyFed run
   (quant8_topk uploads) of each engine, after a warm-up run: the CUDA
   kernel, memcpy and memset time over the sum of the rounds' wall times
   (the profiler's own host cost lengthens the rounds, so the share is a
   lower bound), and the kernels that take the most device time.
3. The scan engine's replays: the same run captured (warm-up and capture
   outside the profiler), then its rounds replayed under the profiler;
   the kernel, memcpy and memset time over the replays' window between
   two CUDA events, and the kernels that take the most device time.

Exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def cuda_ms(torch, fn, iters=5, warmup=1):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def local_training(torch, device):
    import numpy as np
    from torch.func import grad, vmap
    from repro_torch.engine.batch_client import batched_client_update
    from repro_torch.federated.client import ClientConfig, client_update
    from repro_torch.models.mlp_cnn import make_mlp
    from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

    gen = torch.Generator().manual_seed(0)
    model, ccfg, m, cap = make_mlp(), ClientConfig(), 5, 158
    params = tree_map(lambda t: t.to(device),
                      model.init(gen, torch.device("cpu")))
    xs = torch.rand((m, cap, 784), generator=gen).to(device)
    ys = torch.randint(0, 10, (m, cap), generator=gen).to(device)
    steps = ccfg.epochs * ccfg.batches_per_epoch
    idx = torch.randint(0, cap, (m, steps, ccfg.batch_size),
                        generator=gen).to(device)
    noise = [torch.zeros((m,) + tuple(p.shape), device=device)
             for p in tree_leaves(params)]
    sigma = torch.zeros((m,), device=device)
    epochs = np.full(m, ccfg.epochs)
    rows = torch.arange(m, device=device)[:, None]

    def loop():
        return [client_update(model, ccfg, params, xs[c], ys[c],
                              ccfg.epochs, 0.0, idx[c], [n[c] for n in noise])
                for c in range(m)]

    def batched():
        return batched_client_update(model, ccfg, params, xs, ys, epochs,
                                     sigma, idx, noise)

    grad_fn = vmap(grad(lambda p, x, y: model.loss(p, x, y)))

    def vmapped():
        p = tree_map(lambda t: t.expand((m,) + t.shape).clone(), params)
        mom = tree_map(torch.zeros_like, p)
        for i in range(steps):
            g = grad_fn(p, xs[rows, idx[:, i]], ys[rows, idx[:, i]])
            mom = tree_map(lambda mo, gr: ccfg.momentum * mo + gr, mom, g)
            p = tree_map(lambda w, mo: w - ccfg.lr * mo, p, mom)
        return p

    times = {"loop_ms": cuda_ms(torch, loop),
             "batched_ms": cuda_ms(torch, batched),
             "vmap_ms": cuda_ms(torch, vmapped)}
    # one step's gradients both ways, on the same stacked params
    p = tree_map(lambda t: t.expand((m,) + t.shape).clone(), params)
    xb, yb = xs[rows, idx[:, 0]], ys[rows, idx[:, 0]]
    vm = grad_fn(p, xb, yb)
    views = [tree_map(lambda t: t[c].detach().requires_grad_(True), p)
             for c in range(m)]
    with torch.enable_grad():
        losses = [model.loss(views[c], xb[c], yb[c]) for c in range(m)]
    n = len(tree_leaves(p))
    flat = torch.autograd.grad(losses, [x for v in views
                                        for x in tree_leaves(v)])
    per = tree_unflatten(p, [torch.stack(flat[j::n]) for j in range(n)])
    diff = [float((a - b).abs().max())
            for a, b in zip(tree_leaves(per), tree_leaves(vm))]
    times["grad_max_abs_diff"] = max(diff)
    print(f"[train] one cohort's local training (M={m}, {steps} steps): "
          f"loop {times['loop_ms']:.2f} ms, batched {times['batched_ms']:.2f}"
          f" ms, vmap(grad) {times['vmap_ms']:.2f} ms")
    print(f"[train] max |per-client grad - vmap grad| per leaf: {diff}")
    return times


def busy_share(torch, device, rounds):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.federated.server import FLConfig, run_federated

    out = {}
    for engine in ("loop", "batched"):
        cfg = FLConfig(rounds=rounds, upload_codec="quant8_topk",
                       engine=engine)
        run_federated(cfg, device=device)                  # warm-up
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            res = run_federated(cfg, device=device)
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
        dev_us = sum(getattr(e, "self_device_time_total", 0) for e in events)
        wall_ms = 1e3 * sum(res.round_time_s)
        if not dev_us:
            raise RuntimeError("the profiler saw no device time: the busy "
                               "share is not measured")
        busy = dev_us / 1e3 / wall_ms
        top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
        out[engine] = {
            "rounds": rounds, "rounds_wall_ms": wall_ms,
            "device_ms": dev_us / 1e3, "busy_share": busy,
            "idle_share": 1.0 - busy,
            "top": [(e.key[:80], e.self_device_time_total / 1e3, e.count)
                    for e in top]}
        print(f"[profile] {engine}: {rounds} rounds, {wall_ms:.1f} ms of "
              f"rounds, device {dev_us / 1e3:.1f} ms -> busy {100 * busy:.1f}"
              f"%, idle {100 * (1 - busy):.1f}% (profiled)")
        for name, ms, count in out[engine]["top"]:
            print(f"[profile] {engine}:   {ms:9.3f} ms  x{count:<6d} {name}")
    return out


def scan_busy_share(torch, device, rounds):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.engine.round_engine import (
        SegmentCarry, make_segment_step, round_plan,
    )
    from repro_torch.engine.scan_engine import make_scan_spec, scan_operands
    from repro_torch.federated.draws import stack_rounds
    from repro_torch.federated.server import FLConfig, setup_run

    cfg = FLConfig(rounds=rounds, upload_codec="quant8_topk", engine="scan")
    s = setup_run(cfg, device=device)
    spec = make_scan_spec(cfg, (s.sel_spec,))
    step = make_segment_step(s.model, cfg.client, spec,
                             scan_operands(cfg, s))
    plan = round_plan(spec.round, cfg.client, spec.selectors,
                      cfg.n_clients, cfg.m, s.params,
                      s.n_valid.cpu().numpy())
    draws = stack_rounds([s.draws.round(t, plan) for t in range(rounds)])
    step.stage([SegmentCarry(s.params, s.sel_state, torch.zeros(
        (), dtype=torch.int64, device=device))], 0, [draws])  # captures
    torch.cuda.synchronize(device)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start.record()
        step.replay(0, rounds)
        end.record()
        torch.cuda.synchronize(device)
    window_ms = start.elapsed_time(end)
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    dev_us = sum(getattr(e, "self_device_time_total", 0) for e in events)
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    out = {"rounds": rounds, "replays": step.replays,
           "replay_window_ms": window_ms, "device_ms": dev_us / 1e3,
           "busy_share": dev_us / 1e3 / window_ms if dev_us else None,
           "top": [(e.key[:80], e.self_device_time_total / 1e3, e.count)
                   for e in top]}
    if not dev_us:
        print("[profile] scan: the profiler saw no device time in the "
              "replays: busy share not measured")
        return out
    print(f"[profile] scan: {rounds} rounds replayed, window "
          f"{window_ms:.1f} ms, device {dev_us / 1e3:.1f} ms -> busy "
          f"{100 * out['busy_share']:.1f}% (profiled)")
    for name, ms, count in out["top"]:
        print(f"[profile] scan:   {ms:9.3f} ms  x{count:<6d} {name}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--out", default=None, help="write the results as JSON")
    args = ap.parse_args()
    import subprocess
    import torch
    if not torch.cuda.is_available():
        print("torch_engine_profile: no CUDA device is available",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.device import resolve_device
    device = resolve_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(f"[env] torch {torch.__version__}; {smi}")
    result = {"device": smi, "train": local_training(torch, device),
              "profile": busy_share(torch, device, args.rounds),
              "scan": scan_busy_share(torch, device, args.rounds)}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
