#!/usr/bin/env python3
"""Time prefix_avg, weighted_avg, cohort_gather, delta_codec and
flash_attention as their callers call them, for the port under --src (this
checkout's `src` by default), so that two versions can be timed in turns on
one card.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 scripts/torch_kernel_compare.py [--src DIR] [--label NAME]
                                            [--repeats 5]

Every version gets the same inputs, made from fixed seeds:

- prefix_avg: the streaming Shapley walk's call, the prefix models of 250
  walks over the full-width MLP's six stacked leaves (M = 5), through the
  tree wrapper `prefix_avg(stacked, perms, n_k)` with the perms and n_k
  on the card, as the walk passes them (its perms range check included);
- weighted_avg: the dense oracle's call, the (1250, 5) prefix weights of
  250 walks over the full-width MLP's six stacked leaves (M = 5), through
  the tree wrapper `weighted_avg(stacked, weights)`;
- cohort_gather: the batched engine's gather of M = 5 of N = 50 clients
  out of the four client stacks of `setup_run(FLConfig())`, through the
  tree wrapper `cohort_gather(stacks, ids)`, once with the ids on the
  card (in older versions copied to the host first; where the version
  has the device-id entry, read on the card, with the entry's error word
  read back after the call) and, where the version takes them, once with
  host ids (what the loop and batched engines pass);
- delta_codec: the batched engine's upload codec, quant8_topk on the
  full-width MLP's six stacked leaves (M = 5 clients at one round's
  distance from the server weights), through the tree wrapper
  `delta_codec_roundtrip(stacked, params, "quant8_topk")`, which also
  forms the deltas and adds the server weights back;
- flash_attention: one H2O-Danube-3-4B prefill layer (B = 4, S = T =
  8192, Hq = 32, Kh = 8, hd = 120, window 4096) through
  `flash_attention_gqa`, in bf16 (the serving route, as a control, timed
  first) and in float32 (the f32 route);
- flash_attention_bwd: the backward kernel through
  `flash_attention_bwd_cuda` (on the forward's o and lse) at one
  TinyLlama-1.1B training layer (B = 4, S = T = 2048, Hq = 32, Kh = 4, hd
  = 64, causal) and one H2O-Danube-3-4B layer (B = 1, S = T = 8192, Hq =
  32, Kh = 8, hd = 120, window 4096), in bf16 and in float32;
- the wide route (head dims above 128): forward and backward through
  `flash_attention_cuda` / `flash_attention_bwd_cuda` at `chip_smoke.py`'s
  `WIDE_LAYER` (the federated LM example at --d-model 1024: B = 2, S = T =
  2048, Hq = 4, Kh = 2, hd = 256, causal), in bf16 and in float32, and
  the whole train step of `chip_smoke.py` phase 24's wide-heads model
  (`loss_and_grads`, 2 layers at d_model 1024, B = 2 x 2048) in f32 and
  with bf16 activations, which launches each way once a layer.

Each time is a CUDA-event mean over back-to-back calls (`chip_smoke.
time_ms`), taken `--repeats` times; the launches per call are counted.
Besides, the forward's outputs (o, and lse where the version has it) at
`chip_smoke.py` phase 3's shapes (the Danube prefill layer at windows
4096 and 0, and its four edge shapes, both dtypes, from fixed seeds) and
the backward's (dq, dk, dv) at phase 3's backward shapes (the TinyLlama
and Danube layers and four edges, both dtypes) are reduced to one sha256
digest each, so that two versions' outputs can be compared bit for bit;
one backward call of each dtype at the TinyLlama layer and at
`WIDE_LAYER` is profiled (`torch.profiler`), its device time split by
kernel name.

With `--federated-lm`, also `chip_smoke.py` phase 17's two GreedyFed
rounds over LM clients (d_model 512, 8 layers, hd 128, f32: the f32
flash routes both ways) are run and timed, with the peak device memory
and the flash launches.

With `--only REGEX`, only the calls whose name matches are set up and
timed, and the digests are left out (e.g. `--only 'wide|^flash_attention
bf16$'` for the wide route, its steps and the narrow bf16 forward as a
control; `--only '^$'` for the profile alone).

Prints one line per measurement and, last, one JSON object.  Exits
non-zero without a card.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--federated-lm", action="store_true")
    ap.add_argument("--only", default=None,
                    help="time only the calls whose name matches")
    args = ap.parse_args()
    wanted = (lambda name: True) if args.only is None else (
        lambda name: re.search(args.only, name) is not None)

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_kernel_compare: no CUDA device is available",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(Path(args.src).resolve()))
    from chip_smoke import WIDE_LAYER, _stacked_mlp, time_ms
    from repro_torch import kernels
    from repro_torch.core.shapley_batched import prefix_weight_matrix
    from repro_torch.federated.server import FLConfig, setup_run
    from repro_torch.kernels.cohort_gather import cohort_gather
    from repro_torch.kernels.cohort_gather import kernel as gather_kernel
    from repro_torch.kernels.delta_codec import delta_codec_roundtrip
    from repro_torch.kernels.flash_attention import flash_attention_gqa
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.prefix_avg import prefix_avg
    from repro_torch.kernels.weighted_avg import weighted_avg

    device = torch.device("cuda")
    kernels.build()
    print(f"[compare] {args.label}: repro_torch from "
          f"{Path(kernels.__file__).parents[1]} on "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    gen = torch.Generator().manual_seed(5)
    m, r = 5, 250
    stacked, _ = _stacked_mlp(torch, device, gen, m, 0.1)
    perms = torch.stack([torch.randperm(m, generator=gen) for _ in range(r)])
    n_k = torch.randint(20, 300, (m,), generator=gen).float()
    weights = prefix_weight_matrix(perms, n_k).reshape(r * m, m).to(device)

    s = setup_run(FLConfig(), device=device)
    stacks = {"xs": s.xs, "ys": s.ys, "nv": s.n_valid,
              "sigma": torch.as_tensor(s.sigma_k_all, dtype=torch.float32,
                                       device=device)}
    sel = np.array([7, 31, 2, 49, 18])
    clients, server = _stacked_mlp(torch, device,
                                   torch.Generator().manual_seed(4), m, 0.01)
    perms_dev, n_k_dev = perms.to(device), n_k.to(device)
    calls = {"prefix_avg": (lambda _: prefix_avg(stacked, perms_dev,
                                                 n_k_dev), 20),
             "weighted_avg": (lambda _: weighted_avg(stacked, weights), 20),
             "cohort_gather cuda ids": (lambda _: cohort_gather(
                 stacks, torch.as_tensor(sel, device=device)), 200)}
    if hasattr(gather_kernel, "checked_ids"):    # takes host ids
        calls["cohort_gather host ids"] = (
            lambda _: cohort_gather(stacks, sel), 200)
    calls["delta_codec"] = (lambda _: delta_codec_roundtrip(
        clients, server, "quant8_topk"), 200)
    agen = torch.Generator(device=device).manual_seed(6)
    qkv = [torch.randn(shape, generator=agen, device=device)
           for shape in ((4, 8192, 32, 120), (4, 8192, 8, 120),
                         (4, 8192, 8, 120))]
    qkv_bf16 = [x.to(torch.bfloat16) for x in qkv]
    # the bf16 control first, before the f32 route's load warms the card
    calls["flash_attention bf16"] = (lambda _: flash_attention_gqa(
        *qkv_bf16, window=4096), 20)
    calls["flash_attention f32"] = (lambda _: flash_attention_gqa(
        *qkv, window=4096), 3)
    digests = ({} if args.only is not None
               else forward_digests(torch, flash_kernel, device))
    bwd = getattr(flash_kernel, "flash_attention_bwd_cuda", None)
    if bwd is not None:            # versions that have the backward
        for label, shape_q, shape_kv, window in (
                ("TinyLlama", (4, 2048, 32, 64), (4, 2048, 4, 64), 0),
                ("Danube", (1, 8192, 32, 120), (1, 8192, 8, 120), 4096)):
            base = [torch.randn(shape, generator=agen, device=device)
                    for shape in (shape_q, shape_kv, shape_kv, shape_q)]
            for dtype in (torch.bfloat16, torch.float32):
                q, k, v, do = (x.to(dtype) for x in base)
                o, lse = flash_kernel.flash_attention_cuda(
                    q, k, v, window=window, with_lse=True)
                calls[f"flash_attention_bwd {label} {str(dtype)[6:]}"] = (
                    lambda _, a=(q, k, v, o, do, lse), w=window: bwd(
                        *a, window=w), 10 if dtype == torch.bfloat16 else 2)

        b, s_len, hq, kh, hd, window = WIDE_LAYER
        base = [torch.randn(shape, generator=agen, device=device)
                for shape in ((b, s_len, hq, hd), (b, s_len, kh, hd),
                              (b, s_len, kh, hd), (b, s_len, hq, hd))]
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, do = (x.to(dtype) for x in base)
            o, lse = flash_kernel.flash_attention_cuda(
                q, k, v, window=window, with_lse=True)
            dname = str(dtype)[6:]
            calls[f"flash_attention_wide {dname}"] = (
                lambda _, a=(q, k, v): flash_kernel.flash_attention_cuda(
                    *a, window=window), 10)
            calls[f"flash_attention_wide_bwd {dname}"] = (
                lambda _, a=(q, k, v, o, do, lse): bwd(*a, window=window), 3)
        for dname in ("f32", "bf16"):
            name = f"wide-heads train step {dname}"
            if wanted(name):
                calls[name] = (wide_heads_step(torch, device, dname), 3)

    calls = {n: c for n, c in calls.items() if wanted(n)}
    out = {"label": args.label, "device": torch.cuda.get_device_name(0),
           "forward_sha256": digests}
    for name, d in digests.items():
        print(f"[compare] {args.label}: forward output {name}: sha256 {d}",
              flush=True)
    if bwd is not None and args.only is None:
        out["backward_sha256"] = backward_digests(torch, flash_kernel, device)
        for name, d in out["backward_sha256"].items():
            print(f"[compare] {args.label}: backward output {name}: sha256 "
                  f"{d}", flush=True)
    if bwd is not None:
        out["backward_profile"] = backward_profile(torch, flash_kernel,
                                                   device)
        for name, by_kernel in out["backward_profile"].items():
            print(f"[compare] {args.label}: backward {name}, device ms by "
                  f"kernel: {by_kernel}", flush=True)
    for name, (fn, iters) in calls.items():
        kernels.reset_launches()
        fn(0)
        launches = sum(kernels.LAUNCHES.values())
        times = [time_ms(fn, iters=iters) for _ in range(args.repeats)]
        out[name] = {"ms": times, "launches_per_call": launches}
        print(f"[compare] {args.label}: {name}: "
              f"{' '.join(f'{t:.4f}' for t in times)} ms "
              f"(median {sorted(times)[len(times) // 2]:.4f}); {launches} "
              f"launches a call", flush=True)
    if args.federated_lm:
        out["federated_lm"] = federated_lm(torch, device)
        print(f"[compare] {args.label}: federated LM (phase 17): "
              f"{out['federated_lm']}", flush=True)
    print(json.dumps(out))
    return 0


def wide_heads_step(torch, device, dtype="f32"):
    """`chip_smoke.py` phase 24's wide-heads train step (the federated LM
    example's model at --d-model 1024: 4 query heads of 256 over 2 KV
    heads, 2 layers, f32 params, B = 2 x 2048) with activations in `dtype`
    ("f32" or "bf16") as a call on inputs already on the card."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch.train import synth_batch
    from repro_torch.models.lm import model as M
    from repro_torch.tree import tree_map
    cfg = dataclasses.replace(
        get_config("tinyllama_1_1b").reduced(n_layers=2, d_model=1024),
        vocab=1024, dtype="float32")
    gen = torch.Generator().manual_seed(25)
    params = tree_map(lambda t: t.to(device),
                      M.init_params(cfg, gen, device="cpu"))
    batch = {k: v.to(device)
             for k, v in synth_batch(cfg, gen, 2, 2048).items()}
    cfg = dataclasses.replace(
        cfg, dtype={"f32": "float32", "bf16": "bfloat16"}[dtype])
    return lambda _: M.loss_and_grads(cfg, params, batch)


def _bwd_cases():
    """chip_smoke.py phase 3's backward shapes: (label, B, S, T, Hq, Kh,
    hd, causal, window, q_pos offset)."""
    return [("TinyLlama", 4, 2048, 2048, 32, 4, 64, True, 0, 0),
            ("Danube", 1, 8192, 8192, 32, 8, 120, True, 4096, 0),
            ("edge", 2, 1000, 1000, 8, 2, 128, True, 0, 0),
            ("edge", 1, 777, 777, 6, 6, 120, True, 100, 0),
            ("edge", 2, 500, 500, 8, 2, 64, False, 0, 0),
            ("edge", 1, 300, 1300, 8, 4, 64, True, 512, 1000)]


def _bwd_inputs(torch, flash_kernel, device, gen, case, dtype):
    _, b, s_len, t_len, hq, kh, hd, causal, window, off = case
    q, k, v, do = (torch.randn(shape, generator=gen, device=device).to(dtype)
                   for shape in ((b, s_len, hq, hd), (b, t_len, kh, hd),
                                 (b, t_len, kh, hd), (b, s_len, hq, hd)))
    pos = torch.arange(off, off + s_len, device=device)
    o, lse = flash_kernel.flash_attention_cuda(q, k, v, pos, causal=causal,
                                               window=window, with_lse=True)
    return (q, k, v, o, do, lse, pos), {"causal": causal, "window": window}


def backward_digests(torch, flash_kernel, device) -> dict:
    """sha256 of the backward kernel's (dq, dk, dv) at phase 3's backward
    shapes, both dtypes, from fixed seeds."""
    gen = torch.Generator(device=device).manual_seed(25)
    out = {}
    for case in _bwd_cases():
        for dtype in (torch.bfloat16, torch.float32):
            args, kw = _bwd_inputs(torch, flash_kernel, device, gen, case,
                                   dtype)
            h = hashlib.sha256()
            for t in flash_kernel.flash_attention_bwd_cuda(*args, **kw):
                h.update(t.contiguous().view(torch.uint8).cpu().numpy()
                         .tobytes())
            label, b, s_len, t_len, hq, kh, hd, causal, window, off = case
            out[f"{label} B={b} S={s_len} T={t_len} Hq={hq} Kh={kh} hd={hd} "
                f"causal={causal} window={window} q_pos from {off} "
                f"{str(dtype)[6:]}"] = h.hexdigest()
            del args
        torch.cuda.empty_cache()
    return out


def backward_profile(torch, flash_kernel, device) -> dict:
    """Device milliseconds by kernel name of one backward call at the
    TinyLlama layer and at `WIDE_LAYER`, bf16 and f32, under
    `torch.profiler` (after a warm-up call)."""
    from torch.profiler import ProfilerActivity, profile
    from chip_smoke import WIDE_LAYER
    b, s_len, hq, kh, hd, window = WIDE_LAYER
    wide = ("WIDE_LAYER", b, s_len, s_len, hq, kh, hd, True, window, 0)
    gen = torch.Generator(device=device).manual_seed(26)
    out = {}
    for case in (_bwd_cases()[0], wide):
        for dtype in (torch.bfloat16, torch.float32):
            args, kw = _bwd_inputs(torch, flash_kernel, device, gen, case,
                                   dtype)
            flash_kernel.flash_attention_bwd_cuda(*args, **kw)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                flash_kernel.flash_attention_bwd_cuda(*args, **kw)
                torch.cuda.synchronize()
            by_kernel = {}
            for e in prof.key_averages():
                dev_us = getattr(e, "device_time_total", None)
                if dev_us is None:
                    dev_us = getattr(e, "cuda_time_total", 0)
                name = re.search(r"bwd_\w+(<\w+>)?", e.key)
                if name and dev_us > 0:
                    by_kernel[name[0]] = round(dev_us / 1e3, 4)
            out[f"{case[0]} layer {str(dtype)[6:]}"] = by_kernel
            del args
            torch.cuda.empty_cache()
    return out


def federated_lm(torch, device) -> dict:
    """chip_smoke.py phase 17's rounds: their host times after a
    synchronise, the peak device memory and the flash launches."""
    from chip_smoke import phase_federated_lm
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    times = []
    launches = phase_federated_lm(torch, device, times)
    return {"round_s": times, "launches": {k: v for k, v in launches.items()
                                           if "flash" in k},
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def forward_digests(torch, flash_kernel, device) -> dict:
    """sha256 of the forward kernel's o (and lse, where the version has the
    output) at phase 3's shapes, from fixed seeds: the Danube prefill
    layer at windows 4096 and 0 and the four edges, bf16 and f32."""
    import inspect
    has_lse = "with_lse" in inspect.signature(
        flash_kernel.flash_attention_cuda).parameters
    gen = torch.Generator(device=device).manual_seed(14)
    cases = [((4, 8192, 32, 8, 120), 4096), ((4, 8192, 32, 8, 120), 0),
             ((2, 1000, 8, 2, 64), 256), ((1, 1000, 8, 2, 128), 0),
             ((2, 777, 6, 6, 120), 100), ((1, 333, 4, 4, 128), 4096)]
    out = {}
    for (b, s_len, hq, kh, hd), window in cases:
        base = [torch.randn(shape, generator=gen, device=device)
                for shape in ((b, s_len, hq, hd), (b, s_len, kh, hd),
                              (b, s_len, kh, hd))]
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = (x.to(dtype) for x in base)
            h = hashlib.sha256()
            res = flash_kernel.flash_attention_cuda(q, k, v, window=window)
            h.update(res.view(torch.uint8).cpu().numpy().tobytes())
            name = f"B={b} S={s_len} Hq={hq} Kh={kh} hd={hd} " \
                   f"window={window} {str(dtype)[6:]}"
            out[name] = h.hexdigest()
            if has_lse:
                o, lse = flash_kernel.flash_attention_cuda(
                    q, k, v, window=window, with_lse=True)
                h2 = hashlib.sha256(o.view(torch.uint8).cpu().numpy()
                                    .tobytes())
                h2.update(lse.view(torch.uint8).cpu().numpy().tobytes())
                out[name + " with lse"] = h2.hexdigest()
        del base
        torch.cuda.empty_cache()
    return out


if __name__ == "__main__":
    sys.exit(main())
