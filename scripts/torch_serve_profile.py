#!/usr/bin/env python3
"""Where a served request batch's time goes on the card.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 scripts/torch_serve_profile.py [--arch ID] [--layers N]
        [--seq S] [--out FILE]

Serves a full-width config (default H2O-Danube-3-4B; `--layers` cuts the
depth; bf16 activations, f32 params, random weights from a seed) to B = 4
prompts of S = 8192 tokens (`--seq`), with normal patches or frames for a
vision or audio config, as `chip_smoke.py` does, after a warm-up serve:

1. prefill and decode times on the host clock after a device synchronise,
   without the profiler;
2. torch.profiler over one prefill and over 8 decode steps: the
   CUDA kernel, memcpy and memset time over the wall time of each stage
   (the device busy share; the profiler's own host cost lengthens the
   stage, so the share is a lower bound), and the kernels that take the
   most device time, grouped by name.

Exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def stage_profile(torch, label, fn):
    """Device busy share and top kernels of one call of `fn`."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in events) / 1e3
    if not dev_ms:
        raise RuntimeError("the profiler saw no device time: the busy share "
                           "is not measured")
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:10]
    out = {"wall_ms": wall_ms, "device_ms": dev_ms,
           "busy_share": dev_ms / wall_ms,
           "top": [(e.key[:90], e.self_device_time_total / 1e3, e.count)
                   for e in top]}
    print(f"[profile] {label}: wall {wall_ms:.2f} ms (profiled), device "
          f"{dev_ms:.2f} ms -> busy {100 * out['busy_share']:.1f}%, idle "
          f"{100 * (1 - out['busy_share']):.1f}%")
    for name, ms, count in out["top"]:
        print(f"[profile] {label}:   {ms:10.3f} ms  x{count:<6d} {name}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="h2o_danube_3_4b")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers (0: full)")
    ap.add_argument("--seq", type=int, default=8192)
    ap.add_argument("--out", default=None, help="write the results as JSON")
    args = ap.parse_args()
    import subprocess
    import torch
    if not torch.cuda.is_available():
        print("torch_serve_profile: no CUDA device is available",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.device import resolve_device
    from repro_torch.launch.train import synth_batch
    from repro_torch.models.lm import model as M
    from repro_torch.serve import serve_requests

    device = resolve_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(f"[env] torch {torch.__version__}; {smi}")
    cfg = get_config(args.arch)
    if args.layers:
        import dataclasses
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    b, s_len, steps = 4, args.seq, 8
    gen = torch.Generator(device=device).manual_seed(0)
    params = M.init_params(cfg, gen, device=device)
    front = synth_batch(cfg, gen, b, s_len)
    tokens = front.pop("tokens")
    serve_requests(cfg, params, tokens[:1, :2048], 2, device=device,
                   **{k: v[:1] for k, v in front.items()})
    res = serve_requests(cfg, params, tokens, steps, device=device, **front)
    print(f"[serve] {cfg.name}, {cfg.n_layers} layers, B={b}, S={s_len}: "
          f"prefill "
          f"{res.prefill_s * 1e3:.2f} ms, decode "
          f"{res.decode_s * 1e3 / steps:.3f} ms per step "
          f"({res.tokens_per_s:.2f} tokens/s), Shapley "
          f"{res.shapley_s * 1e3:.3f} ms (no profiler)")

    state = {}

    def prefill():
        state["cache"], state["logits"] = M.prefill_step(
            cfg, params, {"tokens": tokens, **front},
            cache_len=s_len + steps)

    def decode():
        tok = torch.argmax(state["logits"], -1)
        for _ in range(steps):
            state["cache"], lg = M.decode_step(cfg, params, state["cache"],
                                               {"token": tok})
            tok = torch.argmax(lg, -1)

    result = {"device": smi, "arch": cfg.name, "layers": cfg.n_layers,
              "batch": b,
              "prompt": s_len, "steps": steps,
              "prefill_ms": res.prefill_s * 1e3,
              "decode_ms_per_step": res.decode_s * 1e3 / steps,
              "tokens_per_s": res.tokens_per_s,
              "shapley_ms": res.shapley_s * 1e3,
              "prefill": stage_profile(torch, "prefill", prefill),
              "decode": stage_profile(torch, f"decode x{steps}",
                                      decode)}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
