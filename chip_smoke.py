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
   card at the main path's shapes and at edge shapes (prefix_avg,
   cohort_gather and delta_codec bitwise; ce_loss at rtol 1e-5 per model
   mean, and per row at rtol 1e-5 plus atol 1e-6 * max|logit|;
   weighted_avg at rtol 1e-6, atol 1e-7), with CUDA-event times of kernel,
   plain version and, where one PyTorch call computes the same function,
   that call, beside the least time the card could take;
4. full-width Shapley: streaming GTG-Shapley of five full-width MNIST MLPs
   on the card against the port's CPU path on the same walks (atol 1e-5);
5. reference run: a small GreedyFed run on the card against the same run
   on the CPU (selections equal, params at atol 1e-4);
6. main path, loop engine: `run_federated(FLConfig(rounds=12))` on the
   card (N=50, M=5, full-width 784-200-100-10 MLP, 10 round-robin then 2
   greedy rounds);
7. main path, batched engine: `FLConfig(engine="batched", rounds=12,
   upload_codec="quant8_topk")` against the loop engine on the same config
   and draws (selections and bytes equal, params and SVs at atol 1e-4);
8. dense oracle: `shapley_impl="batched"` on the batched engine for 4
   rounds against the streaming estimator on the same walks (atol 1e-4).

Each path of phases 6-8 runs with the launch counters zeroed just before
it and read just after; every kernel must launch on its path.  The line
before the last is a JSON object with one entry per kernel; the last line
is `{"ok": true, "device": {...}}`.
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


def _stacked_mlp(torch, device, gen, m, scale):
    """M perturbed copies of a full-width MLP, stacked, and the base."""
    from repro_torch.models.mlp_cnn import make_mlp
    params = make_mlp().init(gen, torch.device("cpu"))
    stacked = {k: {n: torch.stack([t + scale * torch.randn(t.shape,
                                                           generator=gen)
                                   for _ in range(m)]).to(device)
                   for n, t in v.items()} for k, v in params.items()}
    base = {k: {n: t.to(device) for n, t in v.items()}
            for k, v in params.items()}
    return stacked, base


def check_cohort_gather(torch, device):
    """Bitwise (as int32 words) against the plain index_select at the main
    path's four client stacks and at edge rows, and an out-of-range id must
    raise; the JSON entry is one round's four gathers."""
    from repro_torch import kernels
    from repro_torch.federated.server import FLConfig, setup_run
    from repro_torch.kernels.cohort_gather import (
        cohort_gather_ref, cohort_take,
    )

    s = setup_run(FLConfig(), device=device)
    stacks = [("xs", s.xs), ("ys", s.ys), ("n_valid", s.n_valid),
              ("sigma", torch.as_tensor(s.sigma_k_all, device=device))]
    gen = torch.Generator().manual_seed(3)
    edge = torch.randn((9, 2049), generator=gen)
    edge.view(torch.int32)[1, ::3] = -(2 ** 31)             # -0.0
    edge.view(torch.int32)[2, ::2] = 0x7fc01234             # NaN payloads
    stacks.append(("-0/NaN f32", edge.to(device)))
    stacks.append(("bf16 6-byte", torch.randn((6, 3), generator=gen).to(
        device, torch.bfloat16)))
    ids = torch.tensor([7, 31, 2, 49, 18], device=device)
    lib = kernels.library()
    saved = kernels.LAUNCHES["cohort_gather"]

    def launch(flat, sel, out, bad):     # the C entry alone, for timing
        return lib.cohort_gather(flat.data_ptr(), sel.data_ptr(),
                                 out.data_ptr(), bad.data_ptr(),
                                 flat.shape[0], sel.shape[0],
                                 flat.shape[1] * flat.element_size(),
                                 flat.device.index,
                                 kernels.stream_ptr(flat))

    total = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0}
    worst = 0.0
    for i, (name, table) in enumerate(stacks):
        sel = ids % table.shape[0]
        got = cohort_take(table, sel)
        want = cohort_gather_ref(table.reshape(table.shape[0], -1), sel
                                 ).reshape(got.shape)
        words = torch.int16 if table.dtype == torch.bfloat16 else (
            torch.int32 if table.element_size() == 4 else torch.int64)
        require(torch.equal(got.view(words), want.view(words)),
                f"cohort_gather {name} not bitwise equal")
        if i < 4:          # the main path's stacks hold no NaN
            worst = max(worst, float((got.double() - want.double()
                                      ).abs().max()))
        else:
            log(f"[cohort_gather] {name:12s} N={table.shape[0]} "
                f"row {table[0].numel() * table.element_size()} B: bitwise "
                f"equal")
            continue
        flat = table.reshape(table.shape[0], -1)
        out = torch.empty((5, flat.shape[1]), dtype=flat.dtype, device=device)
        bad = torch.zeros((1,), dtype=torch.int32, device=device)
        ms = time_ms(lambda _: launch(flat, sel, out, bad), iters=50)
        require(int(bad.item()) == 0, "cohort_gather flagged a valid id")
        plain_ms = time_ms(lambda _: cohort_gather_ref(flat, sel), iters=50)
        lib_ms = time_ms(lambda _: torch.index_select(flat, 0, sel), iters=50)
        n_bytes = 2 * 5 * flat.shape[1] * flat.element_size() + 5 * 8
        b_ms, b_by = bound_ms(n_bytes, 0)
        total["ms"] += ms
        total["plain_ms"] += plain_ms
        total["library_ms"] += lib_ms
        total["bytes"] += n_bytes
        log(f"[cohort_gather] {name:12s} N={table.shape[0]} M=5 row "
            f"{flat.shape[1] * flat.element_size()} B: bitwise equal; kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, index_select "
            f"{lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    n = s.n_valid.shape[0]
    for bad_ids in ([0, n], [-1]):
        try:
            cohort_take(s.n_valid, torch.tensor(bad_ids, device=device))
        except IndexError:
            continue
        raise AssertionError(f"cohort_gather took ids {bad_ids} of {n} rows")
    log(f"[cohort_gather] ids outside [0, {n}) raise IndexError")
    kernels.LAUNCHES["cohort_gather"] = saved  # check launches do not count
    b_ms, b_by = bound_ms(total["bytes"], 0)
    log(f"[cohort_gather] main-path round (4 stacks): kernel "
        f"{total['ms']:.4f} ms, plain {total['plain_ms']:.4f} ms, "
        f"index_select {total['library_ms']:.4f} ms, bound {b_ms:.4f} ms "
        f"({b_by}); the wrapper adds one flag read per call")
    return {"name": "cohort_gather", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/cohort_gather.cu",
            "replaces": "src/repro/kernels/cohort_gather/kernel.py:37",
            "max_abs_err": worst, "ms": total["ms"],
            "plain_ms": total["plain_ms"], "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": total["library_ms"]}


def check_delta_codec(torch, device):
    """Bitwise against the plain rowwise codec: the three codecs at the six
    main-path leaves (M = 5 deltas of one round's scale), a ragged D = 2049,
    a row of ties, an all-zero row, k = 1, and rows with NaN and inf (NaN
    outputs held as NaNs); the JSON entry is one round's six quant8_topk
    launches."""
    from repro_torch import kernels
    from repro_torch.federated.compression import leaf_topk_k
    from repro_torch.kernels.delta_codec import delta_codec_ref
    from repro_torch.kernels.delta_codec.kernel import delta_codec_cuda
    from repro_torch.tree import tree_leaves, tree_paths

    gen = torch.Generator().manual_seed(4)
    stacked, base = _stacked_mlp(torch, device, gen, 5, 0.01)
    deltas = [(path, (s - b[None]).reshape(5, -1).contiguous()) for path, s, b
              in zip(tree_paths(stacked), tree_leaves(stacked),
                     tree_leaves(base))]
    edge = 0.01 * torch.randn((6, 2049), generator=gen)
    edge[1, 100:400] = -0.25                           # 300 tied maxima
    edge[2] = 0.5 * torch.sign(torch.randn(2049, generator=gen))
    edge[3] = 0.0
    edge[4, [5, 9]] = 3.0
    # a diverging client's deltas: NaN and inf pass through, as in the
    # plain version and the reference
    bad = 0.01 * torch.randn((4, 2049), generator=gen)
    bad[0, 3] = float("nan")
    bad[1, 7] = float("inf")
    bad[2, 1] = float("-inf")
    bad.view(torch.int32)[2, 9] = -4194303            # 0xffc00001, a -NaN
    bad.view(torch.int32)[3, [2, 5, 8]] = 0x7fc01234  # tied NaN payloads
    bad[3, 4] = float("inf")
    cases = deltas + [("edge D=2049", edge.to(device)),
                      ("non-finite D=2049", bad.to(device))]
    saved = kernels.LAUNCHES["delta_codec"]
    worst = 0.0
    for codec in ("quant8", "topk", "quant8_topk"):
        for name, x in cases:
            ks = ([0] if codec == "quant8" else
                  [leaf_topk_k(x.shape[1])] if name in dict(deltas) else
                  [1, 2, 4, leaf_topk_k(2049), 2049])
            for k in ks:
                got = delta_codec_cuda(x, codec, k)
                want = delta_codec_ref(x, codec, k)
                # NaN outputs are held as NaNs, whatever their payloads;
                # every other word bitwise
                nan = torch.isnan(want)
                require(torch.equal(torch.isnan(got), nan)
                        and torch.equal(got[~nan].view(torch.int32),
                                        want[~nan].view(torch.int32)),
                        f"delta_codec {codec} {name} k={k} not bitwise equal")
                fin = torch.isfinite(want)
                if bool(fin.any()):
                    worst = max(worst,
                                float((got[fin] - want[fin]).abs().max()))
        log(f"[delta_codec] {codec}: bitwise equal at the six leaves and the "
            f"ragged/tie/zero/k=1 and NaN/inf rows")
    total = {"ms": 0.0, "plain_ms": 0.0, "bytes": 0, "ops": 0}
    for name, x in deltas:
        k = leaf_topk_k(x.shape[1])
        ms = time_ms(lambda _: delta_codec_cuda(x, "quant8_topk", k))
        plain_ms = time_ms(lambda _: delta_codec_ref(x, "quant8_topk", k),
                           iters=5, warmup=1)
        # read once, write once; per element ~6 ops (abs, max, divide,
        # round, clip, multiply) plus the compares of the keep set
        n_bytes, n_ops = 2 * x.numel() * 4, 8 * x.numel()
        b_ms, b_by = bound_ms(n_bytes, n_ops)
        for key, v in (("ms", ms), ("plain_ms", plain_ms),
                       ("bytes", n_bytes), ("ops", n_ops)):
            total[key] += v
        log(f"[delta_codec] quant8_topk {name:9s} M=5 D={x.shape[1]:6d} "
            f"k={k:5d}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
            f"{b_ms:.4f} ms ({b_by})")
    kernels.LAUNCHES["delta_codec"] = saved   # check launches do not count
    b_ms, b_by = bound_ms(total["bytes"], total["ops"])
    log(f"[delta_codec] main-path round (6 leaves, quant8_topk): kernel "
        f"{total['ms']:.4f} ms, plain {total['plain_ms']:.4f} ms, bound "
        f"{b_ms:.4f} ms ({b_by}); no single PyTorch call computes it")
    return {"name": "delta_codec", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/delta_codec.cu",
            "replaces": "src/repro/kernels/delta_codec/kernel.py:81",
            "max_abs_err": worst, "ms": total["ms"],
            "plain_ms": total["plain_ms"], "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None}


def check_weighted_avg(torch, device):
    """At rtol 1e-6, atol 1e-7 against the plain f32 einsum at the dense
    oracle's (1250, 5) weights x the six main-path leaves, and bf16; the
    JSON entry is one valued round's six launches."""
    from repro_torch import kernels
    from repro_torch.core.shapley_batched import prefix_weight_matrix
    from repro_torch.kernels.weighted_avg import weighted_avg_ref
    from repro_torch.kernels.weighted_avg.kernel import weighted_avg_cuda
    from repro_torch.tree import tree_leaves, tree_paths

    gen = torch.Generator().manual_seed(5)
    m, r = 5, 250
    stacked, _ = _stacked_mlp(torch, device, gen, m, 0.1)
    perms = torch.stack([torch.randperm(m, generator=gen) for _ in range(r)])
    n_k = torch.randint(20, 300, (m,), generator=gen).float()
    weights = prefix_weight_matrix(perms, n_k).reshape(r * m, m).to(device)
    flats = [(p, x.reshape(m, -1)) for p, x in
             zip(tree_paths(stacked), tree_leaves(stacked))]
    saved = kernels.LAUNCHES["weighted_avg"]
    worst = 0.0
    total = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0,
             "ops": 0}
    for name, x in flats + [("bf16 D=20000", torch.randn(
            (m, 20000), generator=gen).to(device, torch.bfloat16))]:
        w = weights.to(x.dtype)
        got = weighted_avg_cuda(x, w)
        want = weighted_avg_ref(x, w)
        err = float((got.float() - want.float()).abs().max())
        if x.dtype == torch.float32:
            worst = max(worst, err)
            require(bool(torch.allclose(got, want, rtol=1e-6, atol=1e-7)),
                    f"weighted_avg {name}: max err {err}")
        else:        # one bf16 rounding of f32 sums
            require(bool(torch.allclose(got.float(), want.float(), rtol=8e-3,
                                        atol=1e-6)),
                    f"weighted_avg {name}: max err {err}")
        ms = time_ms(lambda _: weighted_avg_cuda(x, w))
        plain_ms = time_ms(lambda _: weighted_avg_ref(x, w), iters=10)
        lib_ms = time_ms(lambda _: torch.matmul(w, x))
        n_bytes = (x.numel() + w.numel() + r * m * x.shape[1]
                   ) * x.element_size()
        n_ops = 2 * r * m * x.numel()
        b_ms, b_by = bound_ms(n_bytes, n_ops)
        if name.startswith("layer"):
            for key, v in (("ms", ms), ("plain_ms", plain_ms),
                           ("library_ms", lib_ms), ("bytes", n_bytes),
                           ("ops", n_ops)):
                total[key] += v
        log(f"[weighted_avg] {name:12s} R={r * m} M={m} D={x.shape[1]:6d}: "
            f"max abs err {err:.2e}; kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, torch.matmul {lib_ms:.4f} ms, bound "
            f"{b_ms:.4f} ms ({b_by})")
    kernels.LAUNCHES["weighted_avg"] = saved  # check launches do not count
    b_ms, b_by = bound_ms(total["bytes"], total["ops"])
    log(f"[weighted_avg] main-path valued round (6 leaves): kernel "
        f"{total['ms']:.4f} ms, plain {total['plain_ms']:.4f} ms, "
        f"torch.matmul {total['library_ms']:.4f} ms, bound {b_ms:.4f} ms "
        f"({b_by})")
    return {"name": "weighted_avg", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/weighted_avg.cu",
            "replaces": "src/repro/kernels/weighted_avg/kernel.py:43",
            "max_abs_err": worst, "ms": total["ms"],
            "plain_ms": total["plain_ms"], "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": total["library_ms"]}


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


def drive(torch, device, cfg, label):
    """One full-width run of `cfg` on the card with the launch counters
    zeroed just before and read just after; prints per-round times, the
    Shapley share and peak memory."""
    import numpy as np
    from repro_torch import kernels
    from repro_torch.federated.server import run_federated
    from repro_torch.tree import tree_leaves

    torch.cuda.reset_peak_memory_stats(device)
    kernels.reset_launches()
    res = run_federated(cfg, device=device)
    launches = dict(kernels.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    n_perms = cfg.shapley_max_iters or 50 * cfg.m
    valued = (res.shapley_evals - 2 * cfg.rounds) // (n_perms * cfg.m)
    for t, (rt, st) in enumerate(zip(res.round_time_s, res.shapley_time_s)):
        log(f"[{label}] round {t:2d} sel {res.selections[t].tolist()} "
            f"{rt * 1e3:8.2f} ms (Shapley {st * 1e3:8.2f} ms, "
            f"{100 * st / rt:5.1f}%)")
    steady = res.round_time_s[1:]
    log(f"[{label}] mean round {1e3 * sum(steady) / len(steady):.2f} ms "
        f"after round 0 (round 0 {1e3 * res.round_time_s[0]:.2f} ms); "
        f"Shapley {1e3 * sum(res.shapley_time_s[1:]) / len(steady):.2f} ms "
        f"per round, share "
        f"{100 * sum(res.shapley_time_s[1:]) / sum(steady):.1f}%")
    log(f"[{label}] peak memory {peak_gb:.3f} GB; final acc "
        f"{res.final_acc:.4f}; accuracy curve {res.test_acc}")
    log(f"[{label}] valued rounds {valued}/{cfg.rounds}; upload bytes "
        f"{res.upload_bytes}; dispatches {res.dispatches}; launches "
        f"{launches}")
    require(valued > 0, f"{label}: no round was valued")
    require(all(np.isfinite(float(x.abs().sum())) and x.is_cuda
                for x in tree_leaves(res.params)),
            f"{label}: params not finite")
    require(tuple(res.params["layer0"]["w"].shape) == (784, 200),
            f"{label}: wrong model width")
    require(np.isfinite(res.sv_final).all(), f"{label}: SV not finite")
    require([len(s) for s in res.selections] == [cfg.m] * cfg.rounds,
            f"{label}: cohort sizes")
    return res, launches, valued


def expect_launches(label, launches, want):
    for name, n in want.items():
        require(launches[name] == n,
                f"{label}: {name} launched {launches[name]} times, expected "
                f"{n}")


def phase_main_path(torch, device):
    """The loop engine's 12-round main path."""
    from repro_torch.federated.server import FLConfig

    cfg = FLConfig(rounds=12)
    res, launches, valued = drive(torch, device, cfg, "main")
    expect_launches("loop main path", launches, {
        "prefix_avg": 6 * valued, "ce_loss": valued, "cohort_gather": 0,
        "delta_codec": 0, "weighted_avg": 0})
    require(res.final_acc > 0.2, f"final accuracy {res.final_acc} <= 0.2")
    return launches


def _max_err(a, b):
    from repro_torch.tree import tree_leaves
    return max(float((x.float() - y.float()).abs().max())
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def phase_batched_path(torch, device):
    """The batched engine's 12-round main path with the quant8_topk codec,
    against the loop engine on the same config and the same draws."""
    import dataclasses

    import numpy as np
    from repro_torch.federated.server import FLConfig

    loop_cfg = FLConfig(rounds=12, upload_codec="quant8_topk")
    loop, _, _ = drive(torch, device, loop_cfg, "loop-codec")
    cfg = dataclasses.replace(loop_cfg, engine="batched")
    res, launches, valued = drive(torch, device, cfg, "batched")
    expect_launches("batched path", launches, {
        "prefix_avg": 6 * valued, "ce_loss": valued,
        "cohort_gather": 4 * cfg.rounds, "delta_codec": 6 * cfg.rounds,
        "weighted_avg": 0})
    same = all((a == b).all() for a, b in zip(res.selections,
                                              loop.selections))
    p_err = _max_err(res.params, loop.params)
    sv_err = float(np.abs(res.sv_final - loop.sv_final).max())
    log(f"[engines] batched vs loop, quant8_topk, 12 rounds: selections "
        f"equal {same}; upload bytes {res.upload_bytes} vs "
        f"{loop.upload_bytes}; max param err {p_err:.2e}, max SV err "
        f"{sv_err:.2e} (atol 1e-4)")
    mean = (lambda r: 1e3 * sum(r.round_time_s[1:]) / (cfg.rounds - 1))
    sv_mean = (lambda r: 1e3 * sum(r.shapley_time_s[1:]) / (cfg.rounds - 1))
    log(f"[engines] mean round after round 0, same call: loop "
        f"{mean(loop):.2f} ms (Shapley {sv_mean(loop):.2f} ms), batched "
        f"{mean(res):.2f} ms (Shapley {sv_mean(res):.2f} ms)")
    require(same, "batched and loop selections differ")
    require(res.upload_bytes == loop.upload_bytes
            and res.download_bytes == loop.download_bytes,
            "batched and loop byte counts differ")
    require(p_err <= 1e-4 and sv_err <= 1e-4,
            "batched and loop runs disagree")
    require(res.final_acc > 0.2, f"final accuracy {res.final_acc} <= 0.2")
    return launches


def phase_dense_oracle(torch, device):
    """shapley_impl="batched" on the batched engine for 4 (round-robin)
    rounds, against the streaming estimator on the same walks."""
    import numpy as np
    from repro_torch.federated.server import FLConfig

    cfg = FLConfig(rounds=4, engine="batched", shapley_impl="batched")
    dense, launches, valued = drive(torch, device, cfg, "dense")
    expect_launches("dense-oracle path", launches, {
        "prefix_avg": 0, "ce_loss": valued, "cohort_gather": 4 * cfg.rounds,
        "delta_codec": 0, "weighted_avg": 6 * valued})
    stream, _, _ = drive(torch, device, FLConfig(rounds=4, engine="batched"),
                         "streaming")
    same = all((a == b).all() for a, b in zip(dense.selections,
                                              stream.selections))
    sv_err = float(np.abs(dense.sv_final - stream.sv_final).max())
    p_err = _max_err(dense.params, stream.params)
    log(f"[dense] dense vs streaming SV on the same walks, 4 rounds: "
        f"selections equal {same}; max SV err {sv_err:.2e} (atol 1e-4); "
        f"max param err {p_err:.2e}; SV {dense.sv_final.tolist()}")
    require(same and sv_err <= 1e-4 and p_err <= 1e-4,
            "dense oracle disagrees with the streaming estimator")
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
    entries = [check_prefix_avg(torch, device), check_ce_loss(torch, device),
               check_cohort_gather(torch, device),
               check_delta_codec(torch, device),
               check_weighted_avg(torch, device)]
    phase_full_width_shapley(torch, device)
    phase_reference_run(torch, device)
    paths = {"loop": phase_main_path(torch, device),
             "batched": phase_batched_path(torch, device),
             "dense_oracle": phase_dense_oracle(torch, device)}
    for e in entries:
        by_path = {p: n[e["name"]] for p, n in paths.items()}
        e["launches"] = sum(by_path.values())
        e["launches_by_path"] = by_path
        require(e["launches"] > 0, f"{e['name']} never launched on a path")
    log(f"[done] {time.perf_counter() - t0:.1f} s")
    print(smi)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
