"""Single-device dry-run: count every (arch x shape) step on `meta` tensors
(counterpart of `repro/launch/dryrun.py`, its single-device part).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all

Where the reference lowers and compiles each step for a 512-device mesh
and reads XLA's cost and memory analyses, this runs the port's own step
eagerly on `meta` tensors under `launch.compat.Count`: nothing is computed
or allocated, so a 1T-parameter config costs only the Python of its ops.
Each record holds

  * `hlo_cost` / `memory`: one full-depth count (FLOPs, bytes accessed, the
    live-byte peak with the arguments and the temporaries), `fits` against
    the card's 80 GB, and `kernels`, the hand-written kernels' calls and
    formula terms;
  * `assembled` / `roofline`: the reference's 1- and 2-layer differencing
    (`launch/roofline.py`) and its report: compute and memory seconds on
    one H100, the dominant term, the step's lower bound;
  * `count_s` in place of the reference's `lower_s` / `compile_s`.

Records land in experiments/dryrun_torch/<arch>__<shape>__h100.json.  The
multi-pod mesh, the sharding specs and the collective parse come with
client sharding (ROADMAP); here `n_devices` is 1.
"""
from __future__ import annotations

import argparse
import json
import time
import traceback
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context
from pathlib import Path

import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.device import resolve_device
from repro_torch.launch.compat import Count
from repro_torch.launch.roofline import (
    HBM_BYTES, assembled_roofline, roofline_report,
)
from repro_torch.launch.shapes import (
    SHAPES, batch_struct, decode_structs, pad_vocab, shape_applicable,
)
from repro_torch.models.lm import model as M
from repro_torch.tree import tree_map

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / \
    "dryrun_torch"


def _fill(struct, gen: torch.Generator, device: torch.device, vocab: int):
    """A tensor of `struct`'s shape and dtype on `device`: tokens uniform in
    [0, vocab), floats normal; on `meta` the struct itself."""
    if device.type == "meta":
        return struct
    if struct.dtype.is_floating_point:
        return torch.randn(struct.shape, generator=gen, device=device,
                           dtype=torch.float32).to(struct.dtype)
    return torch.randint(0, vocab, struct.shape, generator=gen,
                         device=device, dtype=struct.dtype)


def build_step(cfg, shape, device="meta", seed: int = 0):
    """(fn, args): the train, prefill or decode step of `cfg` at `shape`
    and its arguments on `device`.  On `meta` they are the shapes.py
    structs; elsewhere params from `seed`, random tokens and inputs of the
    same shapes and dtypes, zeroed caches."""
    device = resolve_device(device)
    gen = torch.Generator(device="cuda" if device.type == "cuda" else "cpu"
                          ).manual_seed(seed)
    params = M.init_params(cfg, gen, device=device)

    def fill(tree):
        return tree_map(lambda s: _fill(s, gen, device, cfg.vocab), tree)

    if shape.kind == "train":
        opt_init, step = M.make_train_step(cfg)
        return step, (params, opt_init(params),
                      fill(batch_struct(cfg, shape)))
    if shape.kind == "prefill":
        def prefill(params, batch):
            return M.prefill_step(cfg, params, batch,
                                  cache_len=shape.seq_len)
        return prefill, (params, fill(batch_struct(cfg, shape)))
    cache, batch = decode_structs(cfg, shape)
    if device.type != "meta":
        cache = M.init_cache(cfg, shape.global_batch, shape.seq_len,
                             device=device)

    def decode(params, cache, batch):
        return M.decode_step(cfg, params, cache, batch)
    return decode, (params, cache, fill(batch))


def count_step(cfg, shape, device="meta") -> dict:
    """`Count.summary()` of one call of the step on `device` (its
    arguments live from the start), with the seconds the count took."""
    fn, args = build_step(cfg, shape, device)
    t0 = time.perf_counter()
    with Count() as c:
        c.track(args)
        fn(*args)
    return dict(c.summary(), count_s=time.perf_counter() - t0)


def run_one(arch: str, shape_name: str, *, assemble: bool = True,
            save: bool = True, cfg_override=None,
            out_dir: Path = OUT_DIR) -> dict:
    shape = SHAPES[shape_name]
    base = cfg_override if cfg_override is not None else get_config(arch)
    applicable, why = shape_applicable(base, shape)
    tag = f"{base.name}__{shape_name}__h100"
    if not applicable:
        rec = {"tag": tag, "status": "skipped", "reason": why}
        if save:
            _save(out_dir, tag, rec)
        return rec

    cfg = pad_vocab(base)
    full = count_step(cfg, shape)
    rec = {
        "tag": tag,
        "status": "ok",
        "arch": base.name,
        "shape": shape_name,
        "mesh": [1],
        "n_devices": 1,
        "count_s": full["count_s"],
        "memory": {k: full[k] for k in ("argument_bytes", "temp_bytes",
                                        "peak_bytes")},
        "hlo_cost": {"flops": full["flops"],
                     "bytes_accessed": full["bytes_accessed"],
                     "compute_s": full["compute_s"]},
        "kernels": full["kernels"],
        "fits": full["peak_bytes"] <= HBM_BYTES,
    }
    if assemble:
        rec["assembled"] = assembled_roofline(cfg, shape)
        rec["roofline"] = roofline_report(cfg, shape, rec, n_devices=1)
    if save:
        _save(out_dir, tag, rec)
    return rec


def _save(out_dir: Path, tag: str, rec: dict) -> None:
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / f"{tag}.json", "w") as f:
        json.dump(rec, f, indent=1)


def summary_line(rec: dict) -> str:
    """One record as the CLI prints it."""
    if rec["status"] != "ok":
        return f"[skip] {rec['tag']}: {rec['reason']}"
    r = rec.get("roofline", {})
    bound = (f" bound={r['step_time_lower_bound_s'] * 1e3:.3f}ms "
             f"dom={r['dominant']}" if r else "")
    return (f"[ok]   {rec['tag']}: flops={rec['hlo_cost']['flops']:.4e} "
            f"bytes={rec['hlo_cost']['bytes_accessed']:.4e} "
            f"peak={rec['memory']['peak_bytes'] / 1e9:.2f}GB "
            f"fits={rec['fits']}{bound} count={rec['count_s']:.2f}s")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all", help="arch id or 'all'")
    ap.add_argument("--shape", default="all",
                    help=f"one of {sorted(SHAPES)} or 'all'")
    ap.add_argument("--no-assemble", action="store_true")
    ap.add_argument("--out-dir", default=str(OUT_DIR))
    ap.add_argument("--jobs", type=int, default=1,
                    help="worker processes (each counts whole records)")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    pairs = [(a, s) for a in archs for s in shapes]
    kw = dict(assemble=not args.no_assemble, out_dir=Path(args.out_dir))
    pool = (ProcessPoolExecutor(args.jobs, mp_context=get_context("spawn"))
            if args.jobs > 1 else None)
    futs = [pool.submit(run_one, a, s, **kw) if pool else None
            for a, s in pairs]
    failures = []
    try:
        for (arch, shape), fut in zip(pairs, futs):
            label = f"{arch} x {shape}"
            try:
                rec = fut.result() if fut else run_one(arch, shape, **kw)
                print(summary_line(rec), flush=True)
            except Exception as e:  # noqa: BLE001 - reported, then raised
                failures.append((label, repr(e)))
                print(f"[FAIL] {label}: {e}", flush=True)
                traceback.print_exception(e)
    finally:
        if pool:
            pool.shutdown()
    if failures:
        raise SystemExit(f"{len(failures)} dry-run failures")
    print("dry-run complete: every combination counted")


if __name__ == "__main__":
    main()
