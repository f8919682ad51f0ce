#!/usr/bin/env python3
"""Time the prefill of Mamba2-370M and Whisper-medium at `chip_smoke.py`
phase 18's full-width shapes for the port under --src (this checkout's
`src` by default), so that two versions can be timed in turns on one
card: here, a version whose `resolve_device` leaves cuDNN's switches at
PyTorch's defaults against one that turns its deterministic algorithms on
(neither model makes a cuDNN call: the SSM's causal conv is a shift-stack,
Whisper's frames come in as embeddings).

Run from the root of a checkout, on a machine with one CUDA card:

    python3 scripts/torch_prefill_compare.py [--src DIR] [--label NAME]
                                             [--repeats 3]

Each model is drawn from a seed on the card (f32 params, bf16
activations), warmed up by a short serve, then served `--repeats` times
with 2 decode steps; the prefill seconds are `ServeResult.prefill_s` (host
clock after a synchronise).  Mamba2: 48 layers, B = 4 x S = 8192.
Whisper: 24 + 24 layers, 1500 frames, B = 4 x 448 decoder tokens.  Prints
one line per model with cuDNN's switches as the version left them and,
last, one JSON object.  Exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

CASES = (("mamba2_370m", 4, 8192), ("whisper_medium", 4, 448))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("torch_prefill_compare: no CUDA device is available",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.configs import get_config
    from repro_torch.launch.train import synth_batch
    from repro_torch.models.lm import model as M
    from repro_torch.serve import serve_requests

    device = torch.device("cuda")
    out = {"label": args.label}
    for arch, b, s_len in CASES:
        cfg = get_config(arch)
        gen = torch.Generator(device=device).manual_seed(18)
        params = M.init_params(cfg, gen, device=device)
        batch = synth_batch(cfg, gen, b, s_len)
        front = {k: v for k, v in batch.items() if k != "tokens"}
        serve_requests(cfg, params, batch["tokens"][:1, :512], 2,
                       device=device, **{k: v[:1] for k, v in front.items()})
        times = [1e3 * serve_requests(cfg, params, batch["tokens"], 2,
                                      device=device, **front).prefill_s
                 for _ in range(args.repeats)]
        flags = {"deterministic": torch.backends.cudnn.deterministic,
                 "benchmark": torch.backends.cudnn.benchmark}
        out[arch] = {"prefill_ms": times,
                     "median_ms": statistics.median(times), "cudnn": flags}
        print(f"[prefill] {args.label}: {arch} B={b} S={s_len} prefill "
              f"median {statistics.median(times):.2f} ms of "
              f"{[round(t, 2) for t in times]} (cudnn {flags})", flush=True)
        del params, batch, front
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
