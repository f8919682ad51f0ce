#!/usr/bin/env python3
"""Time the CNN's Shapley utility in two forms on one card, in turns: the
per-model loop the port keeps (`make_cnn`'s `apply_batched`: B forwards
of `apply`, all R * M prefix models of a round resident at once) and a
batched form (conv0 one convolution with B * 32 output channels over the
shared input, conv1 a grouped convolution with groups=B, the dense layers
batched products, flattened in the reference's NHWC order), scored in
chunks of 25 walks (125 models, ~16.4 GB of activations at n_val = 500;
all 1,250 at once would need ~164 GB).

Run from the root of a checkout, on a machine with one CUDA card:

    python3 scripts/torch_cnn_utility_compare.py [--rounds 4] [--out FILE]

Each form runs `FLConfig(dataset="cifar10", engine="scan", rounds=N)` at
the reference's other defaults (N = 50, M = 5, E = B = 5, batch 32, R =
250 walks, n_val = 500; the batched form with `sv_chunk=125`) in the
order loop, batched, batched, loop: the scan's replay time a round (CUDA
events), its capture and staging, and the peak memory above the set-up.
Then, for each form, the round captured with one graph a stage
(`stage_events`) gives each stage's device time a round, and the utility
alone scores one round's 1,250 random prefix models (CUDA events, chunked
as the engine chunks them), and one utility call of 125 models runs under
`torch.profiler` (device time by kernel name).  The two forms' SVs and
params are compared (the SVs differ in the last bits: another summation
order).  Prints one
line per measurement and, last, one JSON object (also written to --out).
Exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


BATCHED_CHUNK = 125      # models a utility call: 25 of the 250 walks


def batched_form(model, channels=(32, 64)):
    """`model` (the CNN) with the batched forward: B models in one pass,
    channels model-major throughout."""
    import torch
    import torch.nn.functional as F

    def apply_batched(params, x):
        n_models, n = params["head"]["b"].shape[0], x.shape[0]
        hcur = x.permute(0, 3, 1, 2)                       # NHWC -> NCHW
        for i, c in enumerate(channels):
            p = params[f"conv{i}"]
            w = p["w"].permute(0, 4, 3, 1, 2)              # (B, O, I, H, W)
            hcur = F.conv2d(hcur, w.reshape((n_models * c,) + w.shape[2:]),
                            padding="same", groups=1 if i == 0 else n_models)
            hcur = F.max_pool2d(hcur.add_(p["b"].reshape(1, -1, 1, 1))
                                .relu_(), 2, 2)
        # (n, B * C, h, w) -> (B, n, h * w * C): the reference's NHWC order
        hcur = hcur.reshape(n, n_models, channels[-1], *hcur.shape[2:])
        hcur = hcur.permute(1, 0, 3, 4, 2).reshape(n_models, n, -1)
        p = params["dense0"]
        hcur = torch.relu(torch.matmul(hcur, p["w"]) + p["b"][:, None, :])
        p = params["head"]
        return torch.matmul(hcur, p["w"]) + p["b"][:, None, :]

    return model._replace(name="cnn-batched", apply_batched=apply_batched)


def stage_times(torch, device, cfg, model):
    """Each stage's device seconds a round over a whole scan run captured
    one graph a stage."""
    from repro_torch.engine import (
        SegmentCarry, make_scan_spec, make_segment_step, scan_operands,
    )
    from repro_torch.engine.round_engine import round_plan
    from repro_torch.federated.draws import stack_rounds
    from repro_torch.federated.server import setup_run

    s = setup_run(cfg, model=model, device=device)
    spec = make_scan_spec(cfg, (s.sel_spec,))
    plan = round_plan(spec.round, cfg.client, spec.selectors, cfg.n_clients,
                      cfg.m, s.params, s.n_valid.cpu().numpy())
    step = make_segment_step(model, cfg.client, spec, scan_operands(cfg, s),
                             stage_events=True)
    draws = stack_rounds([s.draws.round(t, plan) for t in range(cfg.rounds)])
    step([SegmentCarry(s.params, s.sel_state, torch.zeros(
        (), dtype=torch.int64, device=device))], 0, [draws])
    torch.cuda.synchronize(device)
    return {k: 1e3 * v / cfg.rounds for k, v in step.stage_seconds().items()}


def utility_ms(torch, device, model, sv_chunk, n_val, r, m, iters=3):
    """CUDA-event ms of scoring one round's R * M random prefix models
    with `make_batched_mlp_utility`, chunked as the streaming walk
    chunks them on the card at `sv_chunk`."""
    from repro_torch.core.shapley_batched import (
        chunk_walks_for, make_batched_mlp_utility,
    )
    from repro_torch.data.synth import make_dataset
    from repro_torch.tree import tree_map

    data = make_dataset("cifar10", n_train=10, n_val=n_val, n_test=10,
                        seed=0)
    x = torch.as_tensor(data.x_val, device=device)
    y = torch.as_tensor(data.y_val, dtype=torch.int64, device=device)
    util = make_batched_mlp_utility(model, x, y)
    walks = chunk_walks_for(sv_chunk, r, m, device)
    gen = torch.Generator().manual_seed(0)
    base = model.init(gen, torch.device("cpu"))
    chunk = tree_map(lambda t: (t[None] + 0.01 * torch.randn(
        (walks * m,) + t.shape, generator=gen)).to(device), base)
    n_chunks = r // walks

    def run():
        return [util(chunk) for _ in range(n_chunks)]

    run()
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        run()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / iters, walks


def utility_kernels(torch, device, model, n_val, n_models=125, top=8):
    """Device ms by kernel name of one utility call over `n_models`
    random models (torch.profiler), the largest `top` and the total."""
    from repro_torch.core.shapley_batched import make_batched_mlp_utility
    from repro_torch.data.synth import make_dataset
    from repro_torch.tree import tree_map

    data = make_dataset("cifar10", n_train=10, n_val=n_val, n_test=10,
                        seed=0)
    x = torch.as_tensor(data.x_val, device=device)
    y = torch.as_tensor(data.y_val, dtype=torch.int64, device=device)
    util = make_batched_mlp_utility(model, x, y)
    gen = torch.Generator().manual_seed(0)
    chunk = tree_map(lambda t: (t[None] + 0.01 * torch.randn(
        (n_models,) + t.shape, generator=gen)).to(device),
        model.init(gen, torch.device("cpu")))
    util(chunk)
    torch.cuda.synchronize(device)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        util(chunk)
        torch.cuda.synchronize(device)
    rows = [(e.key, e.count, e.self_device_time_total / 1e3)
            for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")
            and e.self_device_time_total]
    if not rows:
        raise RuntimeError("the profiler saw no device time")
    rows.sort(key=lambda r: -r[2])
    return {"models": n_models, "total_ms": sum(r[2] for r in rows),
            "kernels": sum(r[1] for r in rows),
            "top": [{"name": k[:90], "calls": n, "ms": ms}
                    for k, n, ms in rows[:top]]}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("torch_cnn_utility_compare: no CUDA device is available",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import subprocess

    import numpy as np
    from repro_torch import kernels
    from repro_torch.device import resolve_device
    from repro_torch.federated.server import FLConfig, run_federated
    from repro_torch.models.mlp_cnn import make_classifier
    from repro_torch.tree import tree_leaves

    device = resolve_device("cuda")
    kernels.build()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"[cnn-utility] {smi}; torch {torch.__version__}", flush=True)
    cnn = make_classifier("cifar10")
    forms = {"loop": cnn, "batched": batched_form(cnn)}
    cfg = FLConfig(dataset="cifar10", engine="scan", rounds=args.rounds)
    cfgs = {"loop": cfg,
            "batched": dataclasses.replace(cfg, sv_chunk=BATCHED_CHUNK)}
    out = {"device": smi, "rounds": args.rounds,
           "scan_round_ms": {"loop": [], "batched": []}}
    runs = {}
    for label in ("loop", "batched", "batched", "loop"):
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        mem0 = torch.cuda.memory_allocated(device)
        t0 = time.perf_counter()
        res = run_federated(cfgs[label], model=forms[label], device=device)
        wall = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated(device) - mem0) / 1e9
        ms = 1e3 * sum(res.round_time_s) / cfg.rounds
        out["scan_round_ms"][label].append(ms)
        out.setdefault("capture_s", {})[label] = res.compile_time_s
        out.setdefault("stage_s", {})[label] = res.stage_time_s
        out.setdefault("peak_gb", {})[label] = peak
        runs[label] = res
        print(f"[cnn-utility] scan, {label} form: {ms:.3f} ms a round "
              f"(replays); capture {res.compile_time_s:.2f} s, staging "
              f"{res.stage_time_s:.3f} s, whole run {wall:.1f} s, peak "
              f"{peak:.2f} GB above the set-up", flush=True)
        del res
    sv = float(np.abs(runs["loop"].sv_final - runs["batched"].sv_final).max())
    p = max(float((a - b).abs().max()) for a, b in zip(
        tree_leaves(runs["loop"].params), tree_leaves(runs["batched"].params)))
    same = all((a == b).all() for a, b in zip(runs["loop"].selections,
                                              runs["batched"].selections))
    out["loop_vs_batched"] = {"selections_equal": bool(same),
                              "max_sv_err": sv, "max_param_err": p}
    print(f"[cnn-utility] loop vs batched form: selections equal {same}, "
          f"max SV err {sv:.3e}, max param err {p:.3e}", flush=True)
    del runs
    for label, model in forms.items():
        st = stage_times(torch, device, cfgs[label], model)
        out.setdefault("stage_ms_a_round", {})[label] = st
        print(f"[cnn-utility] {label} form, device ms a round by stage: "
              + ", ".join(f"{k} {v:.3f}" for k, v in st.items()), flush=True)
    for label in ("loop", "batched", "batched", "loop"):
        ms, walks = utility_ms(torch, device, forms[label],
                               cfgs[label].sv_chunk, cfg.n_val, 50 * cfg.m,
                               cfg.m)
        out.setdefault("utility_ms", {}).setdefault(label, []).append(ms)
        print(f"[cnn-utility] utility alone, {label} form: {ms:.3f} ms for "
              f"{50 * cfg.m * cfg.m} models ({walks} walks a chunk)",
              flush=True)
    for label, model in forms.items():
        prof = utility_kernels(torch, device, model, cfg.n_val)
        out.setdefault("utility_kernels", {})[label] = prof
        print(f"[cnn-utility] {label} form, one utility call of "
              f"{prof['models']} models under torch.profiler: "
              f"{prof['kernels']} kernels, {prof['total_ms']:.3f} ms of "
              f"device time; the largest: " + "; ".join(
                  f"{r['name']} x{r['calls']} {r['ms']:.3f} ms"
                  for r in prof["top"]), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
