"""Dry-run: count every (arch x shape x mesh) step on `meta` tensors
(counterpart of `repro/launch/dryrun.py`).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all \
        --mesh both

Where the reference lowers and compiles each step for its (16, 16) and
(2, 16, 16) meshes of 256 / 512 devices and reads XLA's cost and memory
analyses and the collectives of its HLO text, this runs the port's own step
eagerly on `meta` tensors under `launch.compat.Count`: nothing is computed
or allocated, so a 1T-parameter config costs only the Python of its ops.
On a mesh (`--mesh single | multi | both`: the virtual production meshes,
`launch.mesh.make_production_mesh`) the step is rank 0's part of it, on its
blocks of the params, optimizer state and caches (by `launch.sharding`'s
specs, with `launch_cfg`), and its collectives are counted, not run.
`--mesh h100`, the default of the CLI and of `run_one`, counts the step on
one card, as before (the reference's CLI defaults to its (16, 16) mesh).
Each record holds

  * `hlo_cost` / `memory`: one full-depth count per device (FLOPs, bytes
    accessed, the live-byte peak with the arguments and the
    temporaries), `fits` against the card's 80 GB, and `kernels`, the
    hand-written kernels' calls and formula terms;
  * `collective_bytes_toplevel` (on a mesh): the count's collectives in
    the reference's layout (`by_kind`, `counts`, `weighted_total`), with
    `by_axes`, the weighted bytes by the mesh axes they cross;
  * `assembled` / `roofline`: the reference's 1- and 2-layer differencing
    (`launch/roofline.py`) and its report: compute, memory and collective
    seconds per device, the dominant term, the step's lower bound;
  * `count_s` in place of the reference's `lower_s` / `compile_s`.

Records land in experiments/dryrun_torch/<arch>__<shape>__<mesh>.json,
<mesh> one of single, multi (n_devices 256, 512) and h100 (one card).
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
from repro_torch.launch import sharding as SH
from repro_torch.launch.compat import Count, set_mesh
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.roofline import (
    HBM_BYTES, assembled_roofline, collective_s, roofline_report,
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


def mesh_of(name: str):
    """The virtual production mesh of `name` ("single": (16, 16), "multi":
    (2, 16, 16)), or None for "h100" (one card)."""
    if name == "h100":
        return None
    return make_production_mesh(multi_pod=name == "multi")


def _local_meta(tree, specs, mesh):
    """Fresh meta tensors of this rank's block shapes (so a Count holds
    each block's own bytes, not the global leaf's)."""
    def one(leaf, spec):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        return torch.empty(SH.local_shape(tuple(leaf.shape), spec, mesh),
                           dtype=leaf.dtype, device="meta")
    return SH.map_specs(one, tree, specs)


def build_step(cfg, shape, device="meta", seed: int = 0, mesh=None):
    """(fn, args): the train, prefill or decode step of `cfg` at `shape`
    and its arguments on `device`, the batch last.  On `meta` they are the
    shapes.py structs; elsewhere params from `seed`, random tokens and
    inputs of the same shapes and dtypes, zeroed caches.  With `mesh` (on
    `meta`), rank 0's step of that mesh: its blocks of the params,
    optimizer state and caches, the global batch (the step places its
    rows), run under `set_mesh(mesh)`."""
    device = resolve_device(device)
    gen = torch.Generator(device="cuda" if device.type == "cuda" else "cpu"
                          ).manual_seed(seed)
    params = M.init_params(cfg, gen, device=device)
    if mesh is not None:
        params = _local_meta(params, SH.param_specs(cfg, mesh, params), mesh)

    def fill(tree):
        return tree_map(lambda s: _fill(s, gen, device, cfg.vocab), tree)

    def meshed(fn):
        if mesh is None:
            return fn

        def run(*args):
            with set_mesh(mesh):
                return fn(*args)
        return run

    if shape.kind == "train":
        opt_init, step = M.make_train_step(cfg)
        return meshed(step), (params, opt_init(params),
                              fill(batch_struct(cfg, shape)))
    if shape.kind == "prefill":
        def prefill(params, batch):
            return M.prefill_step(cfg, params, batch,
                                  cache_len=shape.seq_len)
        return meshed(prefill), (params, fill(batch_struct(cfg, shape)))
    cache, batch = decode_structs(cfg, shape)
    if mesh is not None:
        cache = _local_meta(cache, SH.cache_specs(cfg, mesh, cache), mesh)
    elif device.type != "meta":
        cache = M.init_cache(cfg, shape.global_batch, shape.seq_len,
                             device=device)
    def decode(params, cache, batch):
        return M.decode_step(cfg, params, cache, batch,
                             cache_len=shape.seq_len)
    return meshed(decode), (params, cache, fill(batch))


def count_step(cfg, shape, device="meta", mesh=None) -> dict:
    """`Count.summary()` of one call of the step on `device` (its
    arguments live from the start: on a mesh this rank's blocks and its
    rows of the batch), with the seconds the count took and, on a mesh,
    the collectives' seconds (`roofline.collective_s`)."""
    fn, args = build_step(cfg, shape, device, mesh=mesh)
    tracked = args
    if mesh is not None:
        batch = args[-1]
        tracked = (*args[:-1], _local_meta(
            batch, SH.batch_specs(cfg, mesh, batch), mesh))
    t0 = time.perf_counter()
    with Count() as c:
        c.track(tracked)
        fn(*args)
    out = dict(c.summary(), count_s=time.perf_counter() - t0)
    out["collective_s"] = collective_s(mesh, out["collectives"]["by_axes"])
    return out


def run_one(arch: str, shape_name: str, *, mesh: str = "h100",
            assemble: bool = True, save: bool = True, cfg_override=None,
            out_dir: Path = OUT_DIR) -> dict:
    shape = SHAPES[shape_name]
    base = cfg_override if cfg_override is not None else get_config(arch)
    applicable, why = shape_applicable(base, shape)
    tag = f"{base.name}__{shape_name}__{mesh}"
    if not applicable:
        rec = {"tag": tag, "status": "skipped", "reason": why}
        if save:
            _save(out_dir, tag, rec)
        return rec

    lm_mesh = mesh_of(mesh)
    cfg = pad_vocab(base)
    if lm_mesh is not None:
        cfg = SH.launch_cfg(cfg, lm_mesh, shape)
    full = count_step(cfg, shape, mesh=lm_mesh)
    n_devices = 1 if lm_mesh is None else lm_mesh.devices
    rec = {
        "tag": tag,
        "status": "ok",
        "arch": base.name,
        "shape": shape_name,
        "mesh": [1] if lm_mesh is None else list(lm_mesh.sizes),
        "n_devices": n_devices,
        "count_s": full["count_s"],
        "memory": {k: full[k] for k in ("argument_bytes", "temp_bytes",
                                        "peak_bytes")},
        "hlo_cost": {"flops": full["flops"],
                     "bytes_accessed": full["bytes_accessed"],
                     "compute_s": full["compute_s"]},
        "kernels": full["kernels"],
        "fits": full["peak_bytes"] <= HBM_BYTES,
    }
    if lm_mesh is not None:
        rec["collective_bytes_toplevel"] = full["collectives"]
    if assemble:
        rec["assembled"] = assembled_roofline(cfg, shape, lm_mesh)
        rec["roofline"] = roofline_report(cfg, shape, rec,
                                          n_devices=n_devices)
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
    coll = rec.get("collective_bytes_toplevel")
    coll = (f" collective={coll['weighted_total']:.4e}B"
            if coll is not None else "")
    return (f"[ok]   {rec['tag']}: flops={rec['hlo_cost']['flops']:.4e} "
            f"bytes={rec['hlo_cost']['bytes_accessed']:.4e}{coll} "
            f"peak={rec['memory']['peak_bytes'] / 1e9:.2f}GB "
            f"fits={rec['fits']}{bound} count={rec['count_s']:.2f}s")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all", help="arch id or 'all'")
    ap.add_argument("--shape", default="all",
                    help=f"one of {sorted(SHAPES)} or 'all'")
    ap.add_argument("--mesh", default="h100",
                    choices=["single", "multi", "both", "h100"],
                    help="one card (the default, as run_one's), the (16, "
                         "16) mesh, the (2, 16, 16) one, or both")
    ap.add_argument("--no-assemble", action="store_true")
    ap.add_argument("--out-dir", default=str(OUT_DIR))
    ap.add_argument("--jobs", type=int, default=1,
                    help="worker processes (each counts whole records)")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    triples = [(a, s, m) for a in archs for s in shapes for m in meshes]
    kw = dict(assemble=not args.no_assemble, out_dir=Path(args.out_dir))
    pool = (ProcessPoolExecutor(args.jobs, mp_context=get_context("spawn"))
            if args.jobs > 1 else None)
    futs = [pool.submit(run_one, a, s, mesh=m, **kw) if pool else None
            for a, s, m in triples]
    failures = []
    try:
        for (arch, shape, mesh), fut in zip(triples, futs):
            label = f"{arch} x {shape} x {mesh}"
            try:
                rec = (fut.result() if fut
                       else run_one(arch, shape, mesh=mesh, **kw))
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
