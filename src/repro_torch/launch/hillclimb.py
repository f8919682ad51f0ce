"""§Perf hillclimbing driver: named config variants per target pair
(counterpart of `repro/launch/hillclimb.py`).

Each variant re-runs the dry-run (`launch/dryrun.py::run_one`, counted on
`meta` tensors) for one (arch, shape) pair with a config delta, on the
single-pod (16, 16) mesh as the reference does, so every hypothesis ->
change -> before/after cycle is one CLI invocation producing a JSON record
under experiments/perf_torch/.

    PYTHONPATH=src python -m repro_torch.launch.hillclimb --target tinyllama_train

`VARIANTS` is the reference's list, whole.  Two of its overrides act on the
layout over the mesh rather than on the model's arithmetic:
`parallelism` (which mesh axes the batch and the weights split over:
"dp" puts "model" among the batch axes and splits no weight) and
`moe_groups` (the dispatch groups, which `launch_cfg` otherwise sets to the
data shards).  A record lists those of its overrides under
`sharding_overrides`.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context
from pathlib import Path

from repro_torch.configs import get_config
from repro_torch.launch.dryrun import run_one

OUT = Path(__file__).resolve().parents[3] / "experiments" / "perf_torch"

LAYOUT_OVERRIDES = ("parallelism", "moe_groups")

# variant name -> (arch, shape, config overrides)
VARIANTS = {
    # ---- tinyllama-1.1b x train_4k (collective-bound, 22x compute) -------
    "tinyllama_train/v0_baseline": ("tinyllama_1_1b", "train_4k", {}),
    "tinyllama_train/v1_bf16_params": (
        "tinyllama_1_1b", "train_4k", {"param_dtype": "bfloat16"}),
    "tinyllama_train/v2_dp": (
        "tinyllama_1_1b", "train_4k", {"parallelism": "dp"}),
    "tinyllama_train/v3_dp_bf16": (
        "tinyllama_1_1b", "train_4k",
        {"parallelism": "dp", "param_dtype": "bfloat16"}),
    "tinyllama_train/v4_dp_chunk2048": (
        "tinyllama_1_1b", "train_4k",
        {"parallelism": "dp", "attn_chunk": 2048}),
    "tinyllama_train/v5_dp_chunk4096": (
        "tinyllama_1_1b", "train_4k",
        {"parallelism": "dp", "attn_chunk": 4096}),
    "tinyllama_train/v6_dp_chunk2048_noremat": (
        "tinyllama_1_1b", "train_4k",
        {"parallelism": "dp", "attn_chunk": 2048, "remat": False}),
    # ---- kimi-k2 x train_4k (most collective-bound absolute) -------------
    "kimi_train/v0_baseline": ("kimi_k2_1t_a32b", "train_4k", {}),
    "kimi_train/v1_bf16_params": (
        "kimi_k2_1t_a32b", "train_4k", {"param_dtype": "bfloat16"}),
    "kimi_train/v2_bf16_bigchunk": (
        "kimi_k2_1t_a32b", "train_4k",
        {"param_dtype": "bfloat16", "attn_chunk": 2048}),
    "kimi_train/v3_bf16_remat_attn": (
        "kimi_k2_1t_a32b", "train_4k",
        {"param_dtype": "bfloat16", "attn_remat": True}),
    "kimi_train/v4_remat_groups64": (
        "kimi_k2_1t_a32b", "train_4k",
        {"param_dtype": "bfloat16", "attn_remat": True, "moe_groups": 64}),
    # ---- hymba-1.5b x train_4k (worst roofline fraction: memory) ---------
    "hymba_train/v0_baseline": ("hymba_1_5b", "train_4k", {}),
    "hymba_train/v1_dp": (
        "hymba_1_5b", "train_4k", {"parallelism": "dp"}),
    "hymba_train/v2_dp_attn_remat": (
        "hymba_1_5b", "train_4k",
        {"parallelism": "dp", "attn_remat": True}),
    "hymba_train/v3_dp_remat_chunk128": (
        "hymba_1_5b", "train_4k",
        {"parallelism": "dp", "attn_remat": True, "ssm_chunk": 128}),
    "hymba_train/v4_dp_remat_bf16": (
        "hymba_1_5b", "train_4k",
        {"parallelism": "dp", "attn_remat": True,
         "param_dtype": "bfloat16"}),
    "hymba_train/v5_dp_remat_chunk64": (
        "hymba_1_5b", "train_4k",
        {"parallelism": "dp", "attn_remat": True, "ssm_chunk": 64}),
    "hymba_train/v6_dp_remat_c128_attnchunk256": (
        "hymba_1_5b", "train_4k",
        {"parallelism": "dp", "attn_remat": True, "ssm_chunk": 128,
         "attn_chunk": 256}),
}


def run_variant(name: str, out_dir: Path = OUT) -> dict:
    arch, shape, overrides = VARIANTS[name]
    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    rec = run_one(arch, shape, mesh="single", assemble=True, save=False,
                  cfg_override=cfg)
    rec["variant"] = name
    rec["overrides"] = overrides
    rec["sharding_overrides"] = sorted(k for k in overrides
                                       if k in LAYOUT_OVERRIDES)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / (name.replace("/", "__") + ".json"), "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def _summ(rec: dict) -> str:
    r = rec["roofline"]
    temp = rec["memory"]["temp_bytes"] / 2 ** 30
    return (f"compute={r['compute_s']:.3f}s memory={r['memory_s']:.3f}s "
            f"collective={r['collective_s']:.3f}s dom={r['dominant']} "
            f"util={r['useful_flops_ratio']:.2f} temp={temp:.1f}GiB "
            f"sharding-only={rec['sharding_overrides']}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--target", default=None,
                    help="prefix filter, e.g. tinyllama_train")
    ap.add_argument("--variant", default=None, help="exact variant name")
    ap.add_argument("--out-dir", default=str(OUT))
    ap.add_argument("--jobs", type=int, default=1,
                    help="worker processes (each counts whole variants)")
    args = ap.parse_args(argv)
    names = [args.variant] if args.variant else [
        n for n in VARIANTS if args.target is None or
        n.startswith(args.target)]
    if args.jobs <= 1:
        recs = (run_variant(n, Path(args.out_dir)) for n in names)
        for name, rec in zip(names, recs):
            print(f"[{name}] {_summ(rec)}", flush=True)
        return
    with ProcessPoolExecutor(args.jobs, mp_context=get_context("spawn")
                             ) as pool:
        futs = [pool.submit(run_variant, n, Path(args.out_dir))
                for n in names]
        for name, fut in zip(names, futs):
            print(f"[{name}] {_summ(fut.result())}", flush=True)


if __name__ == "__main__":
    main()
