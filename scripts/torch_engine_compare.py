#!/usr/bin/env python3
"""Time the port's FL engines on one full-width run, for the port under
--src (this checkout's `src` by default), so that two versions can be timed
in turns on one card.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 scripts/torch_engine_compare.py [--src DIR] [--label NAME]
                                            [--rounds 12] [--selector NAME]

Every version runs the same config, `chip_smoke.py`'s: the reference's
defaults (synthetic MNIST, N = 50, M = 5, E = B = 5, the full-width
784-200-100-10 MLP, R = 250 walks, greedyfed, or --selector) with
quant8_topk uploads, on the loop and batched engines and, where the
version has it, the scan engine (`--selector random` values no client:
its rounds have no Shapley stage).  A warm-up run of each engine comes
first.  For the loop and batched engines the time is the mean round after
round 0 (host clock after a device synchronise, `FLResult.round_time_s`);
for the scan engine it is the replays' device time over the rounds (CUDA
events), with its capture and draw staging beside it.  Prints one line
per engine and, last, one JSON object.  Exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("--rounds", type=int, default=12)
    ap.add_argument("--selector", default="greedyfed")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("torch_engine_compare: no CUDA device is available",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch import kernels
    from repro_torch.federated.server import FLConfig, run_federated

    device = torch.device("cuda")
    kernels.build()
    print(f"[engines] {args.label}: repro_torch from "
          f"{Path(kernels.__file__).parents[1]} on "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    cfg = FLConfig(rounds=args.rounds, upload_codec="quant8_topk",
                   selector=args.selector)
    out = {"label": args.label, "rounds": args.rounds,
           "selector": args.selector}
    engines = ["loop", "batched"]
    try:
        run_federated(dataclasses.replace(cfg, engine="scan", rounds=1),
                      device=device)
        engines.append("scan")
    except NotImplementedError:
        pass
    for engine in engines:
        run = dataclasses.replace(cfg, engine=engine)
        run_federated(run, device=device)                 # warm-up
        res = run_federated(run, device=device)
        if engine == "scan":
            ms = 1e3 * sum(res.round_time_s) / args.rounds
            out[engine] = {"round_ms": ms,
                           "capture_ms": 1e3 * res.compile_time_s,
                           "stage_ms": 1e3 * res.stage_time_s,
                           "wall_ms": 1e3 * res.wall_time_s}
        else:
            ms = 1e3 * sum(res.round_time_s[1:]) / (args.rounds - 1)
            out[engine] = {"round_ms": ms,
                           "round0_ms": 1e3 * res.round_time_s[0],
                           "wall_ms": 1e3 * res.wall_time_s}
        print(f"[engines] {args.label}, {args.selector}: {engine} "
              f"{ms:.3f} ms a round "
              f"({json.dumps(out[engine])})", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
