#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (`src/repro_torch`).

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each printed on its own lines; any failure raises and the script
exits non-zero without a result line:

1. environment: torch / CUDA versions, the card's name and power limit
   (nvidia-smi), the TF32 switches the port turns off;
2. build: nvcc builds the port's CUDA kernels from `src/repro_torch/
   kernels/csrc` (sm_90a) and prints the build time and ptxas report;
3. kernel checks: each kernel against its plain PyTorch version on the
   card at the main path's shapes and at edge shapes (prefix_avg bitwise,
   ce_loss at rtol 1e-5 per model mean, and per row at rtol 1e-5 plus
   atol 1e-6 * max|logit|), with CUDA-event times of kernel, plain version
   and (ce_loss) the PyTorch library call, beside the least time the card
   could take;
4. full-width Shapley: streaming GTG-Shapley of five full-width MNIST MLPs
   on the card against the port's CPU path on the same walks (atol 1e-5);
5. reference run: a small GreedyFed run on the card against the same run
   on the CPU (selections equal, params at atol 1e-4);
6. main path: `run_federated(FLConfig(rounds=12))` on the card (N=50, M=5,
   full-width 784-200-100-10 MLP, 10 round-robin then 2 greedy rounds),
   with the launch counters zeroed just before and read just after.

The line before the last is a JSON object with one entry per kernel; the
last line is `{"ok": true, "device": {...}}`.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

F32_PEAK_FLOPS = 67e12      # H100 SXM float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3


def log(*parts):
    print(*parts, flush=True)


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """Least time for the work: the larger of bytes over HBM rate and
    float32 operations over the non-tensor-core peak."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_PEAK_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call of `fn(i)` by CUDA events."""
    import torch
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# ---------------------------------------------------------------- phases --

def phase_environment(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    from repro_torch.device import resolve_device
    device = resolve_device("cuda")
    log(f"[env] python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}  device {torch.cuda.get_device_name(0)}")
    log(f"[env] nvidia-smi: {smi}")
    log(f"[env] tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    require(not torch.backends.cuda.matmul.allow_tf32
            and not torch.backends.cudnn.allow_tf32, "TF32 must be off")
    return device, smi


def phase_build():
    from repro_torch import kernels
    b = kernels.build()
    kernels.library()
    log(f"[build] {b.path.name} built in {b.seconds:.2f} s")
    for line in b.log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build] {line.strip()}")


def time_prefix_avg(torch, flats, perms, n_k):
    """(kernel ms, plain ms, bound ms, bound_by) for building the prefix
    models of the (M, D) matrices `flats` along the walks `perms`."""
    from repro_torch import kernels
    from repro_torch.kernels.prefix_avg.kernel import prefix_avg_cuda
    from repro_torch.kernels.prefix_avg.ref import prefix_avg_ref, walk_weights

    r, m = perms.shape
    scale, ncum = walk_weights(perms, n_k)
    saved = kernels.LAUNCHES["prefix_avg"]
    ms = time_ms(lambda i: [prefix_avg_cuda(f, perms, scale, ncum)
                            for f in flats])
    kernels.LAUNCHES["prefix_avg"] = saved     # timing launches do not count
    plain_ms = time_ms(lambda i: [prefix_avg_ref(f, perms, n_k)
                                  for f in flats], iters=5, warmup=1)
    # each input read once, each output written once; perms/scale/ncum
    # are R*M * (8 + 4 + 4) bytes per launch; 3 flops per output element
    n_bytes = sum(f.numel() * f.element_size() * (1 + r) + r * m * 16
                  for f in flats)
    b_ms, b_by = bound_ms(n_bytes, 3 * r * sum(f.numel() for f in flats))
    return ms, plain_ms, b_ms, b_by


def check_prefix_avg(torch, device):
    """Bitwise against the plain walk at every main-path leaf and at edge
    shapes, each timed; the JSON entry is the main path's six leaves."""
    from repro_torch.kernels.prefix_avg.ops import prefix_avg
    from repro_torch.kernels.prefix_avg.ref import prefix_avg_ref
    from repro_torch.models.mlp_cnn import make_mlp
    from repro_torch.tree import tree_leaves, tree_paths

    gen = torch.Generator().manual_seed(0)
    m, r = 5, 250                                 # main path: R = 50 * M
    params = make_mlp().init(gen, torch.device("cpu"))
    stacked = {k: {n: torch.stack([t + 0.1 * torch.randn(t.shape,
                                                         generator=gen)
                                   for _ in range(m)]).to(device)
                   for n, t in v.items()} for k, v in params.items()}
    perms = torch.stack([torch.randperm(m, generator=gen)
                         for _ in range(r)]).to(device)
    n_k = torch.randint(20, 300, (m,), generator=gen).float().to(device)
    cases = [(path, leaf.reshape(m, -1), perms, n_k) for path, leaf in
             zip(tree_paths(stacked), tree_leaves(stacked))]
    for mm, rr, d, dtype in ((3, 7, 2049, torch.float32),
                             (1, 4, 4096, torch.float32),
                             (5, 250, 20000, torch.bfloat16)):
        cases.append((f"edge {str(dtype)[6:]}",
                      torch.randn((mm, d), generator=gen).to(device, dtype),
                      torch.stack([torch.randperm(mm, generator=gen)
                                   for _ in range(rr)]).to(device),
                      torch.randint(1, 300, (mm,), generator=gen
                                    ).float().to(device)))

    worst = 0.0
    for name, x, p, nk in cases:
        got = prefix_avg({"w": x}, p, nk)["w"]
        want = prefix_avg_ref(x, p, nk)
        err = float((got.float() - want.float()).abs().max())
        worst = max(worst, err)
        require(torch.equal(got, want),
                f"prefix_avg {name} not bitwise equal (max err {err})")
        ms, plain_ms, b_ms, b_by = time_prefix_avg(torch, [x], p, nk)
        log(f"[prefix_avg] {name:10s} M={x.shape[0]} R={p.shape[0]} "
            f"D={x.shape[1]:6d}: bitwise equal; kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")

    flats = [x for _, x, _, _ in cases[:len(tree_leaves(stacked))]]
    ms, plain_ms, b_ms, b_by = time_prefix_avg(torch, flats, perms, n_k)
    log(f"[prefix_avg] main-path round (6 leaves, D="
        f"{sum(f.shape[1] for f in flats)}): kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    return {"name": "prefix_avg", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/prefix_avg.cu",
            "replaces": "src/repro/kernels/prefix_avg/kernel.py:57",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def check_ce_loss(torch, device):
    """Against the plain logsumexp at the main path's call and at large
    vocabularies, each timed; the JSON entry is the main path's call."""
    import torch.nn.functional as F
    from repro_torch import kernels
    from repro_torch.kernels.ce_loss.kernel import ce_loss_cuda
    from repro_torch.kernels.ce_loss.ref import ce_loss_ref

    gen = torch.Generator().manual_seed(1)
    worst, entry = 0.0, None
    # main path first: 1250 prefix models x 500 validation rows x 10 classes
    for b, rows, v, dtype in ((1250, 500, 10, torch.float32),
                              (1, 4096, 32000, torch.float32),
                              (1, 4096, 2049, torch.float32),
                              (1, 4096, 2049, torch.bfloat16)):
        itemsize = torch.tensor([], dtype=dtype).element_size()
        n_in = b * rows * v * itemsize
        # enough copies (>= 100 MB together) that timing reads miss L2
        copies = [(3 * torch.randn((b * rows, v), generator=gen)
                   ).to(device, dtype)
                  for _ in range(max(1, min(8, -(-100_000_000 // n_in))))]
        labels = torch.randint(0, v, (rows,), generator=gen).to(device)
        logits = copies[0]
        got = ce_loss_cuda(logits, labels)
        want = ce_loss_ref(logits.view(b, rows, v), labels).reshape(-1)
        # per row: rtol 1e-5, plus an atol of 1e-6 * max|logit| for rows
        # where logsumexp - gold cancels (the gold logit dominates)
        atol = 1e-6 * float(logits.float().abs().max())
        err = float((got - want).abs().max())
        require(bool(torch.allclose(got, want, rtol=1e-5, atol=atol)),
                f"ce_loss B={b} R={rows} V={v} {dtype}: max err {err}")
        require(bool(torch.allclose(got.view(b, rows).mean(-1),
                                    want.view(b, rows).mean(-1),
                                    rtol=1e-5, atol=0)),
                f"ce_loss B={b} R={rows} V={v} {dtype}: means differ")
        worst = max(worst, err)

        k = len(copies)
        tiled = labels.repeat(b)
        saved = kernels.LAUNCHES["ce_loss"]
        ms = time_ms(lambda i: ce_loss_cuda(copies[i % k], labels), iters=40)
        kernels.LAUNCHES["ce_loss"] = saved    # timing launches do not count
        plain_ms = time_ms(lambda i: ce_loss_ref(
            copies[i % k].view(b, rows, v), labels), iters=40)
        library_ms = time_ms(lambda i: F.cross_entropy(
            copies[i % k], tiled, reduction="none"), iters=40)
        # logits read once, labels once, one f32 loss per row written;
        # ~4 flops per logit (max, subtract, exp, add)
        b_ms, b_by = bound_ms(n_in + rows * 8 + b * rows * 4,
                              4 * b * rows * v)
        log(f"[ce_loss] rows={b * rows} V={v} {str(dtype)[6:]}: max abs err "
            f"{err:.2e} (rtol 1e-5 + atol {atol:.1e}; model means rtol "
            f"1e-5); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"F.cross_entropy {library_ms:.4f} ms, bound {b_ms:.4f} ms "
            f"({b_by})")
        if entry is None:
            entry = {"name": "ce_loss", "route": "cuda",
                     "source": "src/repro_torch/kernels/csrc/ce_loss.cu",
                     "replaces": "src/repro/kernels/ce_loss/kernel.py:54",
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": library_ms}
        del copies
    entry["max_abs_err"] = worst
    return entry


def phase_full_width_shapley(torch, device):
    from repro_torch.core.aggregation import tree_stack
    from repro_torch.core.shapley_batched import (
        _draw_perms, gtg_shapley_streaming, make_batched_mlp_utility,
    )
    from repro_torch.data.synth import make_dataset
    from repro_torch.models.mlp_cnn import make_mlp
    from repro_torch.tree import tree_map

    gen = torch.Generator().manual_seed(2)
    model, m = make_mlp(), 5
    data = make_dataset("mnist", n_train=10, n_val=500, n_test=10, seed=0)
    w_prev = model.init(gen, torch.device("cpu"))
    clients = [tree_map(lambda t: t + 0.05 * torch.randn(t.shape,
                                                         generator=gen),
                        w_prev) for _ in range(m)]
    n_k = torch.tensor([120.0, 40.0, 75.0, 200.0, 10.0])
    perms = _draw_perms(gen, m, 20)
    out = []
    for dev in (device, torch.device("cpu")):
        x = torch.as_tensor(data.x_val, device=dev)
        y = torch.as_tensor(data.y_val, dtype=torch.int64, device=dev)
        to = (lambda t, d=dev: t.to(d))
        stacked = tree_map(to, tree_stack(clients))
        prev = tree_map(to, w_prev)
        sv, stats = gtg_shapley_streaming(
            stacked, n_k.to(dev), prev, lambda p: -model.loss(p, x, y),
            make_batched_mlp_utility(model, x, y), perms.to(dev))
        require(stats.utility_evals == 20 * m + 2, f"evals {stats}")
        out.append(sv.cpu())
    err = float((out[0] - out[1]).abs().max())
    log(f"[shapley] full-width MLP, 20 walks: SV on the card {out[0].tolist()}")
    log(f"[shapley] max |SV cuda - SV cpu| = {err:.2e} (atol 1e-5)")
    require(err <= 1e-5, "full-width SV disagrees between card and CPU")


def phase_reference_run(torch, device):
    from repro_torch.federated.client import ClientConfig
    from repro_torch.federated.server import FLConfig, run_federated
    from repro_torch.tree import tree_leaves

    cfg = FLConfig(n_clients=6, m=3, rounds=4, n_train=600, n_val=100,
                   n_test=100, eval_every=2, shapley_max_iters=6,
                   client=ClientConfig(epochs=2, batches_per_epoch=2,
                                       batch_size=16))
    gpu = run_federated(cfg, device=device)
    cpu = run_federated(cfg, device="cpu")
    for a, b in zip(gpu.selections, cpu.selections):
        require((a == b).all(), f"selections differ: {a} vs {b}")
    err = max(float((a.cpu() - b).abs().max()) for a, b in
              zip(tree_leaves(gpu.params), tree_leaves(cpu.params)))
    sv_err = float(abs(gpu.sv_final - cpu.sv_final).max())
    log(f"[reference] small run card vs CPU: selections equal, max param "
        f"err {err:.2e}, max SV err {sv_err:.2e} (atol 1e-4)")
    require(err <= 1e-4 and sv_err <= 1e-4, "card run disagrees with CPU")


def phase_main_path(torch, device):
    import numpy as np
    from repro_torch import kernels
    from repro_torch.federated.server import FLConfig, run_federated
    from repro_torch.tree import tree_leaves

    cfg = FLConfig(rounds=12)
    torch.cuda.reset_peak_memory_stats(device)
    kernels.reset_launches()
    res = run_federated(cfg, device=device)
    launches = dict(kernels.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9

    n_leaves = len(tree_leaves(res.params))
    n_perms = cfg.shapley_max_iters or 50 * cfg.m
    valued = (res.shapley_evals - 2 * cfg.rounds) // (n_perms * cfg.m)
    for t, (rt, st) in enumerate(zip(res.round_time_s, res.shapley_time_s)):
        log(f"[main] round {t:2d} sel {res.selections[t].tolist()} "
            f"{rt * 1e3:8.2f} ms (Shapley {st * 1e3:8.2f} ms, "
            f"{100 * st / rt:5.1f}%)")
    steady = res.round_time_s[1:]
    log(f"[main] mean round {1e3 * sum(steady) / len(steady):.2f} ms after "
        f"round 0 (round 0 {1e3 * res.round_time_s[0]:.2f} ms); Shapley "
        f"share {100 * sum(res.shapley_time_s[1:]) / sum(steady):.1f}%")
    log(f"[main] peak memory {peak_gb:.3f} GB; final acc {res.final_acc:.4f}; "
        f"accuracy curve {res.test_acc}")
    log(f"[main] valued rounds {valued}/{cfg.rounds}; launches {launches}")
    require(valued > 0, "no round was valued")
    require(launches["prefix_avg"] == n_leaves * valued,
            f"prefix_avg launched {launches['prefix_avg']} times, expected "
            f"{n_leaves} x {valued}")
    require(launches["ce_loss"] == valued,
            f"ce_loss launched {launches['ce_loss']} times, expected {valued}")
    require(all(np.isfinite(float(x.abs().sum())) and x.is_cuda
                for x in tree_leaves(res.params)), "params not finite")
    require(tuple(res.params["layer0"]["w"].shape) == (784, 200),
            "wrong model width")
    require(np.isfinite(res.sv_final).all(), "SV not finite")
    require(res.final_acc > 0.2, f"final accuracy {res.final_acc} <= 0.2")
    require([len(s) for s in res.selections] == [cfg.m] * cfg.rounds,
            "cohort sizes")
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    t0 = time.perf_counter()
    device, smi = phase_environment(torch)
    phase_build()
    entries = [check_prefix_avg(torch, device), check_ce_loss(torch, device)]
    phase_full_width_shapley(torch, device)
    phase_reference_run(torch, device)
    launches = phase_main_path(torch, device)
    for e in entries:
        e["launches"] = launches[e["name"]]
    log(f"[done] {time.perf_counter() - t0:.1f} s")
    print(smi)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
