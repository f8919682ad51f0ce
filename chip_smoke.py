#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (`src/repro_torch`).

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each printed on its own lines; any failure raises and the script
exits non-zero without a result line:

1. environment: torch / CUDA versions, the card's name and power limit
   (nvidia-smi), the TF32 switches the port turns off;
2. build: nvcc builds the port's CUDA kernels from `src/repro_torch/
   kernels/csrc` (sm_90a) and prints the build time and, for each
   entry function, ptxas's registers, shared memory and spills;
3. kernel checks: each kernel against its plain PyTorch version on the
   card at the main path's shapes and at edge shapes (prefix_avg,
   cohort_gather, delta_codec and weighted_avg bitwise; ce_loss at rtol
   1e-5 per model mean, and per row at rtol 1e-5 plus atol 1e-6 *
   max|logit|), with CUDA-event times of kernel,
   plain version and, where one PyTorch call computes the same function,
   that call, beside the least time the card could take.  Kernels are
   timed through their wrappers; for the redesigned ones the C entry
   alone is timed too (`c_entry_ms`).  ce_loss (rows packed per block,
   16-byte loads, a persistent grid) is timed over F.cross_entropy at
   four shapes; flash_attention (bf16 on wgmma tensor cores fed by a TMA
   ring) gives its TFLOP/s and its time over SDPA's, and its f32 route
   (split-TF32 products on the same tensor cores) its time over f32
   SDPA's, beside the split-TF32 bound and the f32 CUDA-core bound;
   weighted_avg (one launch for the tree, the cohort's stack values in
   registers, 16-byte evict-first stores),
   cohort_gather (one launch for the tree, ids checked on the host and
   passed by value, no flag and no sync), delta_codec (one launch for
   the tree, each row split over a cluster of 8 blocks that keep it in
   shared memory, the delta and the add-back inside the kernel) and
   prefix_avg (one launch for the tree, each block's walks staged in
   shared memory with their weights and running sizes formed there, the
   stack words in registers, 16-byte evict-first stores) are timed as the
   main path calls them, over the six leaves and the four stacks at once;
   prefix_avg and weighted_avg over `torch.matmul` of the prefix-weight
   matrix; cohort_gather's device-id entry (the scan engine's: ids read on
   the card, an id out of range written into an error word) is held
   bitwise against its plain version at the main path's four stacks, an
   id of N must set the word and raise when it is read, and it is timed
   through the wrapper and as a C entry; prefix_avg and weighted_avg
   also take a quarantined cohort (two rows hold w_prev at weight 2^-100,
   w_prev has entries below 2^-26, walks start with one or both of those
   rows, so the walk's products are subnormal and the dense oracle's
   prefix weights are clamped to ~7.9e-19) and must equal their plain
   versions bit for bit (prefix_avg on the card and on the CPU);
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
8. scan engine: `FLConfig(engine="scan", rounds=12,
   upload_codec="quant8_topk")` against the batched engine in the same
   call (selections, bytes and eval history equal, params and SVs within
   1e-6, bitwise expected), and again in segments of 4 rounds (bitwise the
   whole run); the round captured as a CUDA graph and replayed under
   `set_sync_debug_mode("error")`; both engines' round times, the capture
   and staging times, the host syncs of each run and the memory above the
   set-up;
9. dense oracle: `shapley_impl="batched"` on the batched engine for 4
   rounds against the streaming estimator on the same walks (atol 1e-4);
10. faults: phase 8's config with `faults=FaultSpec()` (rate 0.1, nan /
   sign_flip / crash, scale 10) and `quarantine=True` on the loop,
   batched and scan engines, 12 rounds: selections, quarantined counts
   (which must be > 0), upload bytes and eval rounds equal, scan against
   batched within 1e-6 (bitwise expected), loop against batched at 1e-4;
   a NaN storm (rate 1, nan) on the scan for 4 rounds left at the initial
   params bitwise, with no upload byte and all-zero SVs; the dense oracle
   under the default faults for 4 rounds against the port's CPU run of
   the same config (atol 1e-4); the scan's replay time a round with and
   without hardening, in turns in the same call, held to no bound;
11. serving: `serve_requests` on full-width, full-depth H2O-Danube-3-4B
   (bf16 activations, f32 params, random weights from a seed): B = 4
   prompts of 8192 tokens, 32 greedy decode steps against the 4096-slot
   window ring, exact Shapley over the 4 requests; prefill must launch
   flash_attention once per layer (24) and decode never;
12. serving parity: the same model at full width, 2 layers and window
   1024, f32, an S = 2048 prompt (flash prefill, S > window, S % window
   == 0), on the card against the port's CPU path with the same weights,
   decode teacher-forced with the CPU's tokens: prefill cache and logits
   at every step at atol 2e-3, rtol 2e-3, request SVs at 1e-4; and on the
   card, decode logits against `forward` at the same position;
13. grid: `repro_torch.grid.run_grid` at phase 8's widths (the reference's
   defaults, T = 12) over 9 cells in 4 partitions: greedyfed x seeds
   {0, 1} with s_fedavg seed 0 (one partition switching two strategies
   on the device); greedyfed x {0, 1} with quant8_topk; fedavg x {0, 1};
   power_of_choice x {0, 1} with eval_every=3 on seed 1.  It runs in
   segments of 4 rounds into a checkpoint directory; every cell must
   equal its solo scan run on the card bit for bit (selections, bytes,
   eval history, SVs, params); a second grid stopped after one segment
   and resumed must equal the first bit for bit; each partition captures
   one round graph holding its S replicas' rounds (one replay a round,
   each kernel of a replica's round S times in it) and replays under
   `set_sync_debug_mode("error")`.  Printed and held to no bound: each
   partition's replay time a round beside the sum of its cells' solo
   replay times, the capture and staging, the memory above the set-up;
14. telemetry (`repro_torch.telemetry`) on phase 8's scan: off, with a
   file sink, with the live tap (each round's record copied into a
   pinned host ring inside the captured round, a host thread emitting
   `round_tap` as rounds land) and with a capture window (`trace_dir`:
   the round captured as one graph a stage between CUDA timing events,
   and a `torch.profiler` trace), all four bitwise, every stream valid;
   the loop and batched engines with a sink bitwise their runs without
   one, their `round_metrics` the scan's in selections and bytes; phase
   13's grid with a sink in segments of 4, killed after one segment and
   resumed, bitwise phase 13's grid with each cell's rounds 0..11
   streamed; liveness: a one-segment 12-round scan (a one-cell grid) must
   emit at least half of its taps before its `segment_end`.  Printed and
   held to no bound: the replay time a round off, with the sink and with
   the tap, two turns in one call; the `profile` event's stage seconds
   and source; the round's cost card and the compile seconds;
15. LM training at full width and depth: TinyLlama-1.1B (22 layers,
   d_model 2048, 32 / 4 heads of 64, d_ff 5632, vocab 32000, bf16
   activations, f32 params, AdamW, remat) through `repro_torch.launch.
   train`'s LM-mode functions from a seeded init, 3 steps on one fixed
   B = 4 x S = 2048 batch: the loss finite and strictly falling,
   flash_attention launched 44 times a step (22 forward, 22 recomputed by
   remat) and flash_attention_bwd 22, a second run from the same seed
   bitwise equal; printed and held to no bound: ms a step, tokens/s, peak
   memory and the step's flops over 989 TFLOP/s;
16. training parity: the same widths cut to 2 layers, f32, B = 1, S = 2048
   (the flash branch): loss and gradients on the card against the port's
   CPU path with the same weights (loss at rtol 1e-4, each gradient leaf
   at 5e-5 x its max |grad|, a limit that the same step with TF32 matrix
   products must exceed, and does: both readings are printed);
17. GreedyFed on an LM: `examples/federated_lm_torch.py`'s round functions
   at --d-model 512 --layers 8 --seq 2048 --batch 2 --local-steps 2
   --clients 6 --select 3 --rounds 2 (hd 128, f32: the flash branch's f32
   route forward and backward): valid selections, finite SVs, both flash
   entries launched, the round times printed;
18. the other LM families served at full width (seeded weights drawn on
   the card, f32 params, bf16 activations, 32 greedy decode steps, exact
   Shapley over B = 4 requests): Mamba2-370M (48 layers, S = 8192, no
   flash launch), Hymba-1.5B (32 layers, S = 8192, G = 5, window 1024: 32
   flash launches), Whisper-medium (24 + 24 layers, 1500 frames, 448
   decoder tokens: dense attention, 0), Qwen3-MoE-30B-A3B cut to 4 layers
   (all 128 experts, S = 4096: 4) and InternVL2-76B cut to 2 layers (256
   patches, S = 4096: 2); prefill and decode ms, tokens/s, peak memory and
   launches printed beside the card's name and power limit; the launch
   counts required, log-prob sums finite and <= 0, SVs summing to the grand
   coalition.  Kimi-K2 is held on the CPU only (one f32 layer of its
   experts is 67.6 GB);
19. families parity: each of the five on the card against the port's CPU
   path with the same weights, f32, full width (the MoE with all 128
   experts), 2 layers (InternVL2 1, for the CPU's time), B = 1: forward
   logits and aux, every prefill cache (k / v rings, SSM states and conv
   windows, cross k / v) and 3 teacher-forced decode steps at atol and
   rtol 2e-3, aux at 1e-5; Hymba at S = 2048 runs the f32 flash route at
   G = 5;
20. hybrid training: Hymba-1.5B at full width and depth (bf16
   activations, f32 params, AdamW, remat), B = 4 x S = 2048, 3 steps on
   one batch through `launch/train.py`'s LM-mode functions, twice: a
   strictly falling loss, the runs bitwise equal, 64 flash_attention and
   32 flash_attention_bwd launches a step (the bf16 backward at G = 5);
   ms a step, tokens/s and peak memory printed.

Phase 3 also holds flash_attention against its plain version at one
layer's full prefill shape (B = 4, Hq = 32, Kh = 8, S = T = 8192, hd =
120), windows 4096 and 0, bf16 (atol 3e-2) and f32 (atol 2e-5), and at
ragged S, hd 64 / 128 and Hq = Kh; it times `scaled_dot_product_attention`
with the same banded mask as a yardstick the port never calls.  The bf16
route rounds the softmax probabilities to bf16 before they multiply V
(the reference keeps them in f32); its error is printed and held to the
same atol 3e-2, and besides elementwise to 5e-3 + 1e-2 |want| and in the
mean to 5e-3 of mean |want|.  The f32 route keeps f32 P and takes each
product as three TF32 products of split operands (hi hi + hi lo + lo hi);
its bound counts those three at the TF32 peak, and the f32 FMA bound of the
CUDA cores is printed beside it.

Phase 3 also holds flash_attention_bwd (no atomics; both routes on wgmma
tensor cores fed by TMA: bf16 with P and dS rounded to bf16 before the
products that read them, f32 as split-TF32 products) against its plain
versions at the full TinyLlama layer (B = 4, S = T = 2048, Hq = 32, Kh =
4, hd = 64, causal) and the Danube layer (B = 1, Hq = 32, Kh = 8, hd =
120, window 4096, S = 8192), bf16 and f32, and at ragged S, hd 128, G =
1, non-causal and a q_pos offset, dq / dk / dv element by element: f32
against `attention_bwd_ref` within 2e-5 max |grad|; bf16 against
`attention_bwd_bf16_ref` (its own arithmetic) within 2^-7 |grad| + 2e-5
max |grad| (the kernel rounds each f32 result once to bf16) plus each
element's `attention_bwd_bf16_slack` (P or dS on either side of a bf16
tie in the two versions), and against the exact `attention_bwd_ref`
within the departure bound 2^-7 |grad| + 2^-8 max |grad| and mean |err|
<= 2^-8 mean |grad|.  Two launches bitwise equal; the forward's output
with its lse output bitwise the output without, the lse the plain
log-sum-exp at atol 1e-4; each route's two product kernels hold wgmma
(HGMMA) instructions at both head-dim paddings in the built library's
SASS (cuobjdump).  It times the kernel, its plain version and the
backward of `scaled_dot_product_attention` at the TinyLlama layer (the
f32 route's SDPA at the Danube layer too) beside the bound
(2.5 x the forward's 4 hd flops a pair, at 989 TFLOP/s for bf16; for f32
as three split-TF32 products at 495 TFLOP/s, as the forward's f32 route
is bounded, with the f32 FMA bound of the CUDA cores printed beside it),
with the TFLOP/s of the 14 hd flops a pair the kernel does and of the
bound's 10 hd.

Each path of phases 6-11, 13-15, 17, 18 and 20 runs with the launch
counters zeroed just before it and read just after (18 and 20 together
are the "families" path); every kernel must launch on its path.  A captured
graph's launches are counted when it is captured and not when it is
replayed, so the scan path counts its warm-up round's launches plus each
graph's times its replays.  The line
before the last is a JSON object with one entry per kernel; the last line
is `{"ok": true, "device": {...}}`.
"""
from __future__ import annotations

import json
import math
import re
import shutil
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent

F32_PEAK_FLOPS = 67e12      # H100 SXM float32 outside the tensor cores
TF32_PEAK_FLOPS = 495e12    # H100 SXM TF32 tensor cores, dense
BF16_PEAK_FLOPS = 989e12    # H100 SXM bf16 tensor cores, dense
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3


def log(*parts):
    print(*parts, flush=True)


def bound_ms(n_bytes: float, n_ops: float,
             peak: float = F32_PEAK_FLOPS) -> tuple[float, str]:
    """Least time for the work: the larger of bytes over HBM rate and
    operations over the peak rate for their type (float32 outside the
    tensor cores unless `peak` says otherwise)."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / peak * 1e3
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
    """Build the kernels; print each entry function ptxas compiled
    (demangled where c++filt is found) with its registers, shared memory
    and spills."""
    from repro_torch import kernels
    b = kernels.build()
    kernels.library()
    log(f"[build] {b.path.name} built in {b.seconds:.2f} s")
    names = re.findall(r"Compiling entry function '(\w+)'", b.log)
    filt = shutil.which("c++filt")
    plain = (subprocess.run([filt, *names], capture_output=True, text=True,
                            check=True, timeout=60).stdout.splitlines()
             if filt and names else names)
    demangled = dict(zip(names, plain))
    for line in b.log.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            log(f"[build] entry {demangled[entry[1]]}")
        elif ("registers" in line or "spill" in line
              or "Performance" in line):
            log(f"[build] {line.strip()}")


def hgmma_counts(lib_path) -> dict:
    """The HGMMA (wgmma) instructions in each entry function of the built
    library, from cuobjdump's SASS, by mangled name."""
    cuobjdump = (shutil.which("cuobjdump")
                 or "/usr/local/cuda/bin/cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib_path)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m[1]
            counts[fn] = 0
        elif fn is not None and "HGMMA" in line:
            counts[fn] += 1
    return counts


def time_prefix_avg(torch, tree, perms, n_k):
    """(ms through the tree wrapper, plain ms, bound ms, bound_by) for
    building the prefix models of every (M, ...) leaf of `tree` along the
    walks `perms`, as the main path calls it."""
    from repro_torch import kernels
    from repro_torch.kernels.prefix_avg import prefix_avg, prefix_avg_ref
    from repro_torch.tree import tree_leaves

    r, m = perms.shape
    leaves = tree_leaves(tree)
    saved = kernels.LAUNCHES["prefix_avg"]
    ms = time_ms(lambda i: prefix_avg(tree, perms, n_k))
    kernels.LAUNCHES["prefix_avg"] = saved     # timing launches do not count
    plain_ms = time_ms(lambda i: [prefix_avg_ref(x.reshape(m, -1), perms, n_k)
                                  for x in leaves], iters=5, warmup=1)
    # each input read once (the stacks, the (R, M) int64 perms and the (M,)
    # f32 n_k), each output written once; 3 flops per output element
    n_bytes = sum(x.numel() * x.element_size() * (1 + r) for x in leaves) \
        + perms.numel() * 8 + m * 4
    b_ms, b_by = bound_ms(n_bytes, 3 * r * sum(x.numel() for x in leaves))
    return ms, plain_ms, b_ms, b_by


def check_prefix_avg(torch, device):
    """Bitwise against the plain walk at every main-path leaf, all six in
    one launch as the streaming walk makes it, and at edge cases, each tree
    in one launch: M = 1, 3, 5 and 12 (above the eight clients held in
    registers), bf16, 16-byte and one-column leaves side by side, views 4
    bytes past a 16-byte boundary, R not a multiple of the walks a block
    takes, non-integer n_k, and a slice of the walks (a chunked walk).
    Each case is timed through the tree wrapper; the JSON entry is the main
    path's round, through the wrapper (`ms`) and the C entry alone
    (`c_entry_ms`), with `torch.matmul` of the prefix-weight matrix as its
    library call."""
    from repro_torch import kernels
    from repro_torch.core.shapley_batched import prefix_weight_matrix
    from repro_torch.kernels.prefix_avg import prefix_avg, prefix_avg_ref
    from repro_torch.kernels.prefix_avg.kernel import c_args, walks_per_block
    from repro_torch.tree import tree_leaves, tree_paths

    gen = torch.Generator().manual_seed(0)
    m, r = 5, 250                                 # main path: R = 50 * M
    stacked, _ = _stacked_mlp(torch, device, gen, m, 0.1)
    perms = torch.stack([torch.randperm(m, generator=gen)
                         for _ in range(r)]).to(device)
    n_k = torch.randint(20, 300, (m,), generator=gen).float().to(device)

    def walks(mm, rr):
        return torch.stack([torch.randperm(mm, generator=gen)
                            for _ in range(rr)]).to(device)

    def edge_tree(mm, dtype, widths):
        flat = torch.randn((1 + mm * 1000,), generator=gen).to(device, dtype)
        tree = {f"d{d}": torch.randn((mm, d), generator=gen).to(device, dtype)
                for d in widths}
        tree["offset"] = flat[1:].view(mm, 1000)  # 4 or 2 bytes past 16
        return tree

    cases = [("main path", stacked, perms, n_k)]
    for mm, rr, dtype, widths, whole in (
            (3, 7, torch.float32, (2049,), True),
            (1, 4, torch.float32, (4096,), True),
            (5, 250, torch.bfloat16, (20000,), True),
            (5, 13, torch.float32, (2048, 2049, 10, 1000), False),
            (12, 11, torch.float32, (3000, 10), False),
            (12, 9, torch.bfloat16, (4096, 1001), True),
            (5, 250, torch.bfloat16, (20000, 100, 10, 1001), False)):
        n = torch.randint(1, 300, (mm,), generator=gen).float()
        if not whole:                              # non-integer counts
            n = n + torch.rand((mm,), generator=gen)
        cases.append((f"M={mm} {str(dtype)[6:]}",
                      edge_tree(mm, dtype, widths), walks(mm, rr),
                      n.to(device)))
    cases.append(("walk slice", stacked, perms[100:150], n_k))
    q_stacked, q_base, q_nk, q_perms = _quarantined_cohort(torch, device, gen)
    cases.append(("quarantined", q_stacked, q_perms, q_nk))

    worst = 0.0
    for name, tree, p, nk in cases:
        before = kernels.LAUNCHES["prefix_avg"]
        got = prefix_avg(tree, p, nk)
        require(kernels.LAUNCHES["prefix_avg"] == before + 1,
                f"prefix_avg {name}: the tree took more than one launch")
        kernels.LAUNCHES["prefix_avg"] = before   # checks do not count
        mm = p.shape[1]
        for path, x, y in zip(tree_paths(tree), tree_leaves(tree),
                              tree_leaves(got)):
            want = prefix_avg_ref(x.reshape(mm, -1), p, nk).reshape(y.shape)
            err = float((y.float() - want.float()).abs().max())
            worst = max(worst, err)
            require(torch.equal(y, want),
                    f"prefix_avg {name} {path} not bitwise equal (max err "
                    f"{err})")
        del got
        ms, plain_ms, b_ms, b_by = time_prefix_avg(torch, tree, p, nk)
        log(f"[prefix_avg] {name:12s} M={mm:2d} R={p.shape[0]:3d} "
            f"D={sum(x[0].numel() for x in tree_leaves(tree)):6d} in "
            f"{len(tree_leaves(tree))} leaves: bitwise equal; through the "
            f"wrapper {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
            f"{b_ms:.4f} ms ({b_by})")

    # the quarantined walks: the all-masked prefixes (rows 0 and 1 of walks
    # 0-99, row 0 of walks 100-149) average 2^-100 w_prev / 2^-100, whose
    # subnormal products move the entries below 2^-26 off w_prev: the
    # kernel keeps them as the plain walk does, on the card and on the CPU
    got = prefix_avg(q_stacked, q_perms[:150], q_nk)
    kernels.LAUNCHES["prefix_avg"] -= 1
    moved = masked_rows = 0
    for x, y, b in zip(tree_leaves(q_stacked), tree_leaves(got),
                       tree_leaves(q_base)):
        want = prefix_avg_ref(x.reshape(m, -1).cpu(), q_perms[:150].cpu(),
                              q_nk.cpu())
        require(torch.equal(y.reshape(want.shape).cpu(), want),
                "prefix_avg quarantined walks: card kernel != CPU plain")
        rows = y.reshape(150, m, -1)
        masked = torch.cat([rows[:100, :2].reshape(200, -1), rows[100:, 0]])
        masked_rows = masked.shape[0]
        moved += int((masked != b.reshape(1, -1)).sum())
    require(moved > 0, "prefix_avg quarantined walks: no subnormal product "
            "moved an all-masked prefix off w_prev")
    log(f"[prefix_avg] quarantined walks: {masked_rows} all-masked prefix "
        f"rows a leaf; {moved} of their entries below 2^-26 come out off "
        f"w_prev through subnormal products, bitwise the plain walk on the "
        f"card and on the CPU")
    del got

    ms, plain_ms, b_ms, b_by = time_prefix_avg(torch, stacked, perms, n_k)
    flats = [x.reshape(m, -1) for x in tree_leaves(stacked)]
    outs = [torch.empty((r * m, f.shape[1]), device=device) for f in flats]
    calls = c_args(list(zip(flats, outs)), perms, n_k)
    require(len(calls) == 1, "prefix_avg: six leaves need one launch")
    lib = kernels.library()
    c_entry_ms = time_ms(lambda i: kernels.check_launch(
        lib.prefix_avg_f32(*calls[0]), "prefix_avg"))
    # the C entry at other walks a block (argument 6): longer blocks make
    # fewer, longer waves
    by_walks = {}
    for w in (2, 4, 12, 50):
        args = list(calls[0])
        args[6] = w
        by_walks[w] = time_ms(lambda i: kernels.check_launch(
            lib.prefix_avg_f32(*args), "prefix_avg"))
    log(f"[prefix_avg] C entry by walks a block: {walks_per_block(m)} (the "
        f"plan's) {c_entry_ms:.4f} ms, " + ", ".join(
            f"{w} {t:.4f} ms" for w, t in by_walks.items()))
    del outs
    # the same function as one product a leaf: the (R*M, M) prefix weights
    # (built outside the timer) times the leaf's (M, D) stack
    weights = prefix_weight_matrix(perms.cpu(), n_k.cpu()).reshape(
        r * m, m).to(device)
    library_ms = time_ms(lambda i: [torch.matmul(weights, f) for f in flats])
    log(f"[prefix_avg] main-path round (6 leaves, one launch, D="
        f"{sum(f.shape[1] for f in flats)}): through the wrapper {ms:.4f} "
        f"ms, the C entry alone {c_entry_ms:.4f} ms; plain {plain_ms:.4f} "
        f"ms, torch.matmul of the prefix weights {library_ms:.4f} ms "
        f"(wrapper / torch.matmul {ms / library_ms:.3f}, C entry / "
        f"torch.matmul {c_entry_ms / library_ms:.3f}), bound {b_ms:.4f} ms "
        f"({b_by}; C entry / bound {c_entry_ms / b_ms:.3f})")
    return {"name": "prefix_avg", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/prefix_avg.cu",
            "replaces": "src/repro/kernels/prefix_avg/kernel.py:57",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms,
            "c_entry_ms": c_entry_ms, "c_entry_ms_by_walks": by_walks}


def check_ce_loss(torch, device):
    """Against the plain logsumexp at the main path's call and at large
    vocabularies, each timed; the JSON entry is the main path's call."""
    import torch.nn.functional as F
    from repro_torch import kernels
    from repro_torch.kernels.ce_loss.kernel import (
        VARIANTS, ce_loss_cuda, launch_plan,
    )
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
        # the C entry alone as well: at V = 10 the wrapper's checks and
        # plan cost the host about as much as the launch costs the card
        plan = launch_plan(b * rows, v, torch.cuda.get_device_properties(
            device).multi_processor_count)
        c_entry = getattr(kernels.library(), "ce_loss_f32"
                          if dtype == torch.float32 else "ce_loss_bf16")
        out = torch.empty((b * rows,), dtype=torch.float32, device=device)
        c_entry_ms = time_ms(lambda i: kernels.check_launch(c_entry(
            copies[i % k].data_ptr(), labels.data_ptr(), out.data_ptr(),
            b * rows, v, rows, VARIANTS.index(plan.variant), plan.blocks,
            out.device.index, kernels.stream_ptr(out)), "ce_loss"), iters=40)
        kernels.LAUNCHES["ce_loss"] = saved    # timing launches do not count
        plain_ms = time_ms(lambda i: ce_loss_ref(
            copies[i % k].view(b, rows, v), labels), iters=40)
        library_ms = time_ms(lambda i: F.cross_entropy(
            copies[i % k], tiled, reduction="none"), iters=40)
        # logits read once, labels once, one f32 loss per row written;
        # ~4 flops per logit (max, subtract, exp, add)
        b_ms, b_by = bound_ms(n_in + rows * 8 + b * rows * 4,
                              4 * b * rows * v)
        log(f"[ce_loss] rows={b * rows} V={v} {str(dtype)[6:]} "
            f"({plan.variant} variant): max abs err "
            f"{err:.2e} (rtol 1e-5 + atol {atol:.1e}; model means rtol "
            f"1e-5); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"F.cross_entropy {library_ms:.4f} ms (kernel / F.cross_entropy "
            f"{ms / library_ms:.3f}), bound {b_ms:.4f} ms ({b_by}); the C "
            f"entry alone {c_entry_ms:.4f} ms ({c_entry_ms / library_ms:.3f} "
            f"of F.cross_entropy)")
        if entry is None:
            entry = {"name": "ce_loss", "route": "cuda",
                     "source": "src/repro_torch/kernels/csrc/ce_loss.cu",
                     "replaces": "src/repro/kernels/ce_loss/kernel.py:54",
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": library_ms,
                     "c_entry_ms": c_entry_ms}
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


def _quarantined_cohort(torch, device, gen, m=5, r=250):
    """A main-path cohort after the quarantine screen: rows 1 and 3 are
    quarantined, so they hold w_prev and weigh 2^-100 in the walks;
    every fifth entry of w_prev is scaled by 2^-40, below 2^-26, so
    2^-100 times it is subnormal.  Walks 0-49 start with rows 1 then 3,
    walks 50-99 with 3 then 1, walks 100-149 with 1 alone.  Returns
    (stacked, w_prev, n_k, perms)."""
    from repro_torch.faults import TINY_WEIGHT
    from repro_torch.tree import tree_leaves

    stacked, base = _stacked_mlp(torch, device, gen, m, 0.1)
    for s_leaf, b_leaf in zip(tree_leaves(stacked), tree_leaves(base)):
        b_leaf.view(-1)[::5] *= 2.0 ** -40
        s_leaf[1] = b_leaf
        s_leaf[3] = b_leaf
    n_k = torch.randint(20, 300, (m,), generator=gen).float()
    n_k[[1, 3]] = TINY_WEIGHT
    rows = []
    for i in range(r):
        rest = torch.randperm(m, generator=gen).tolist()
        head = [1, 3] if i < 50 else [3, 1] if i < 100 else [1] \
            if i < 150 else []
        rows.append(head + [k for k in rest if k not in head])
    return stacked, base, n_k.to(device), torch.tensor(rows).to(device)


def check_cohort_gather(torch, device):
    """Bitwise (as integer words) against the plain index_select at the
    main path's four client stacks, gathered in one call as the batched
    engine does, and at edge rows; ids outside [0, N) must raise, from the
    host and from the card.  The JSON entry is one round's gather, timed
    through the tree wrapper with the engine's host ids (`ms`) and through
    the C entry alone (`c_entry_ms`)."""
    import numpy as np
    from repro_torch import kernels
    from repro_torch.federated.server import FLConfig, setup_run
    from repro_torch.kernels.cohort_gather import (
        cohort_gather, cohort_gather_ref, cohort_take,
    )
    from repro_torch.kernels.cohort_gather.kernel import (
        c_args, checked_ids, device_c_args, error_word, raise_on_error,
    )

    s = setup_run(FLConfig(), device=device)
    stacks = {"xs": s.xs, "ys": s.ys, "n_valid": s.n_valid,
              "sigma": torch.as_tensor(s.sigma_k_all, dtype=torch.float32,
                                       device=device)}
    gen = torch.Generator().manual_seed(3)
    edge = torch.randn((9, 2049), generator=gen)
    edge.view(torch.int32)[1, ::3] = -(2 ** 31)             # -0.0
    edge.view(torch.int32)[2, ::2] = 0x7fc01234             # NaN payloads
    edges = {"-0/NaN f32": edge.to(device),
             "bf16 6-byte": torch.randn((6, 3), generator=gen).to(
                 device, torch.bfloat16)}
    sel = np.array([7, 31, 2, 49, 18])          # the engine's host ids
    sel_dev = torch.as_tensor(sel, device=device)
    saved = kernels.LAUNCHES["cohort_gather"]

    def words(t):
        return t.view(torch.int16 if t.dtype == torch.bfloat16 else (
            torch.int32 if t.element_size() == 4 else torch.int64))

    got = cohort_gather(stacks, sel)
    require(kernels.LAUNCHES["cohort_gather"] == saved + 1,
            "cohort_gather: the round's four stacks took more than a launch")
    worst = 0.0
    for name, table in list(stacks.items()) + list(edges.items()):
        ids = sel % table.shape[0]
        out = got[name] if name in stacks else cohort_take(table, ids)
        want = cohort_gather_ref(table.reshape(table.shape[0], -1),
                                 torch.as_tensor(ids, device=device)
                                 ).reshape(out.shape)
        require(torch.equal(words(out), words(want)),
                f"cohort_gather {name} not bitwise equal")
        if name in stacks:      # the main path's stacks hold no NaN
            worst = max(worst, float((out.double() - want.double()
                                      ).abs().max()))
        log(f"[cohort_gather] {name:12s} N={table.shape[0]} row "
            f"{table[0].numel() * table.element_size()} B: bitwise equal")
    n = s.n_valid.shape[0]
    for bad_ids in ([0, n], [-1]):
        for form in (np.array, lambda i: torch.tensor(i, device=device)):
            try:
                cohort_gather(stacks, form(bad_ids))
            except IndexError:
                continue
            raise AssertionError(f"cohort_gather took ids {bad_ids} of {n} "
                                 "rows")
    log(f"[cohort_gather] ids outside [0, {n}) raise IndexError, from the "
        f"host and from the card")

    # the device-id entry, as a captured round calls it: ids on the card,
    # the caller's error word, nothing read back until the caller reads it
    word = error_word(device)
    got = cohort_gather(stacks, sel_dev, error=word)
    for name, table in stacks.items():
        want = cohort_gather_ref(table.reshape(table.shape[0], -1), sel_dev
                                 ).reshape(got[name].shape)
        require(torch.equal(words(got[name]), words(want)),
                f"cohort_gather device ids {name} not bitwise equal")
        worst = max(worst, float((got[name].double() - want.double()
                                  ).abs().max()))
    raise_on_error(word, n)
    bad = sel_dev.clone()
    bad[2] = n
    cohort_gather(stacks, bad, error=word)
    require(int(word.item()) == n, f"error word {int(word.item())}, not {n}")
    try:
        raise_on_error(word, n)
        raise AssertionError("an id of N did not raise after the run")
    except IndexError:
        pass
    log(f"[cohort_gather] device-id entry at the main path's four stacks: "
        f"bitwise equal; an id of N={n} set the error word to {n} and "
        f"raised IndexError when the word was read after the launch")

    flats = {k: t.reshape(t.shape[0], -1) for k, t in stacks.items()}
    ms = time_ms(lambda _: cohort_gather(stacks, sel), iters=200)
    cuda_ids_ms = time_ms(lambda _: cohort_gather(stacks, sel_dev), iters=200)
    word = error_word(device)
    device_ids_ms = time_ms(lambda _: cohort_gather(stacks, sel_dev,
                                                    error=word), iters=200)
    lib = kernels.library()
    outs = [torch.empty((5, f.shape[1]), dtype=f.dtype, device=device)
            for f in flats.values()]
    args = c_args(list(zip(flats.values(), outs)), checked_ids(sel, n))
    c_entry_ms = time_ms(lambda _: kernels.check_launch(
        lib.cohort_gather(*args), "cohort_gather"), iters=200)
    dargs = device_c_args(list(zip(flats.values(), outs)), sel_dev, word)
    device_c_entry_ms = time_ms(lambda _: kernels.check_launch(
        lib.cohort_gather_ids(*dargs), "cohort_gather"), iters=200)
    raise_on_error(word, n)
    kernels.LAUNCHES["cohort_gather"] = saved  # check launches do not count
    total = {"plain_ms": 0.0, "library_ms": 0.0, "bytes": 0}
    for name, flat in flats.items():
        plain_ms = time_ms(lambda _: cohort_gather_ref(flat, sel_dev),
                           iters=200)
        lib_ms = time_ms(lambda _: torch.index_select(flat, 0, sel_dev),
                         iters=200)
        n_bytes = 2 * 5 * flat.shape[1] * flat.element_size() + 5 * 8
        b_ms, b_by = bound_ms(n_bytes, 0)
        total["plain_ms"] += plain_ms
        total["library_ms"] += lib_ms
        total["bytes"] += n_bytes
        log(f"[cohort_gather] {name:12s} N={flat.shape[0]} M=5 row "
            f"{flat.shape[1] * flat.element_size()} B: plain "
            f"{plain_ms:.4f} ms, index_select {lib_ms:.4f} ms, bound "
            f"{b_ms:.4f} ms ({b_by})")
    b_ms, b_by = bound_ms(total["bytes"], 0)
    log(f"[cohort_gather] main-path round (4 stacks, one launch): through "
        f"the wrapper with host ids {ms:.4f} ms, the C entry alone "
        f"{c_entry_ms:.4f} ms; device ids (the scan's form): through the "
        f"wrapper with the caller's error word {device_ids_ms:.4f} ms, with "
        f"its own word read back {cuda_ids_ms:.4f} ms, the C entry alone "
        f"{device_c_entry_ms:.4f} ms; plain {total['plain_ms']:.4f} ms, "
        f"index_select {total['library_ms']:.4f} ms (wrapper / index_select "
        f"{ms / total['library_ms']:.3f}), bound {b_ms:.4f} ms ({b_by})")
    return {"name": "cohort_gather", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/cohort_gather.cu",
            "replaces": "src/repro/kernels/cohort_gather/kernel.py:37",
            "max_abs_err": worst, "ms": ms, "plain_ms": total["plain_ms"],
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": total["library_ms"], "c_entry_ms": c_entry_ms,
            "cuda_ids_ms": cuda_ids_ms, "device_ids_ms": device_ids_ms,
            "device_ids_c_entry_ms": device_c_entry_ms}


def check_delta_codec(torch, device):
    """Bitwise against the plain rowwise codec, through the single-matrix
    launcher: the three codecs at the six main-path leaves (M = 5 deltas of
    one round's scale), a ragged D = 2049, a row of ties, an all-zero row,
    k = 1, rows with NaN and inf (NaN outputs held as NaNs), and rows whose
    ties and non-finite values fall in different blocks of a row's cluster
    at D = 2049 and 156,800.  Then the tree wrapper at the six leaves, one
    launch a call, bitwise against `params + delta_codec_ref(stack -
    params)`.  The JSON entry is one round's quant8_topk call, timed
    through the tree wrapper (`ms`) and through the C entry alone
    (`c_entry_ms`)."""
    from repro_torch import kernels
    from repro_torch.federated.compression import leaf_topk_k
    from repro_torch.kernels.delta_codec import (
        delta_codec_ref, delta_codec_roundtrip,
    )
    from repro_torch.kernels.delta_codec.kernel import (
        CLUSTER, delta_codec_cuda, leaf_slice, leaf_tables, occupancy,
    )
    from repro_torch.kernels.delta_codec.ref import CODEC_IDS
    from repro_torch.tree import tree_leaves, tree_paths

    gen = torch.Generator().manual_seed(4)
    m = 5
    stacked, base = _stacked_mlp(torch, device, gen, m, 0.01)
    paths, stacks, refs = (tree_paths(stacked), tree_leaves(stacked),
                           tree_leaves(base))
    cases = [(path, (s - b[None]).reshape(m, -1).contiguous(),
              [leaf_topk_k(b.numel())])
             for path, s, b in zip(paths, stacks, refs)]
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
    ks = [1, 2, 4, leaf_topk_k(2049), 2049]
    cases += [("edge D=2049", edge.to(device), ks),
              ("non-finite D=2049", bad.to(device), ks)]
    # the cluster's blocks own slices of a row: ties, NaNs and infs that
    # fall in different slices
    for d in (2049, 156800):
        sl = leaf_slice(d)
        x = 0.01 * torch.randn((5, d), generator=gen)
        x[0] = 0.125                                   # one value everywhere
        x[1, sl - 50:2 * sl + 50] = -0.25              # over two boundaries
        x[2, [0, d - 1]] = 3.0                         # first and last slice
        x[3, [3, 5 * sl + 1]] = float("nan")
        x[3, [sl + 7, 6 * sl]] = float("inf")
        x[4, (CLUSTER - 1) * sl:] = 0.0625             # the last slice tied
        cases.append((f"straddling D={d}", x.to(device),
                      sorted({1, 2, (sl + 100) // 2, leaf_topk_k(d), d})))

    saved = kernels.LAUNCHES["delta_codec"]
    worst = 0.0

    def same(got, want, what):
        # NaN outputs are held as NaNs, whatever their payloads; every
        # other word bitwise
        nan = torch.isnan(want)
        require(torch.equal(torch.isnan(got), nan)
                and torch.equal(got[~nan].view(torch.int32),
                                want[~nan].view(torch.int32)),
                f"delta_codec {what} not bitwise equal")
        fin = torch.isfinite(want)
        return float((got[fin] - want[fin]).abs().max()) if bool(
            fin.any()) else 0.0

    def plain_round(codec):
        out = []
        for s, b in zip(stacks, refs):
            d = b.numel()
            k = leaf_topk_k(d) if codec != "quant8" else 0
            delta = s.reshape(m, d) - b.reshape(1, d)
            out.append((b.reshape(1, d) + delta_codec_ref(delta, codec, k)
                        ).reshape(s.shape))
        return out

    for codec in CODEC_IDS:
        for name, x, ks in cases:
            for k in ([0] if codec == "quant8" else ks):
                worst = max(worst, same(delta_codec_cuda(x, codec, k),
                                        delta_codec_ref(x, codec, k),
                                        f"{codec} {name} k={k}"))
        before = kernels.LAUNCHES["delta_codec"]
        got = tree_leaves(delta_codec_roundtrip(stacked, base, codec))
        require(kernels.LAUNCHES["delta_codec"] == before + 1,
                "delta_codec: the six leaves took more than one launch")
        for path, g, want in zip(paths, got, plain_round(codec)):
            worst = max(worst, same(g, want, f"{codec} tree {path}"))
        log(f"[delta_codec] {codec}: bitwise equal at the six leaves, the "
            f"ragged/tie/zero/k=1 and NaN/inf rows and the rows straddling "
            f"the cluster's slices; the tree wrapper in one launch bitwise "
            f"equal to params + delta_codec_ref(stack - params)")

    codec = "quant8_topk"
    ms = time_ms(lambda _: delta_codec_roundtrip(stacked, base, codec),
                 iters=200)
    flats = [s.reshape(m, -1) for s in stacks]
    lib = kernels.library()
    dev, stream = flats[0].device.index, kernels.stream_ptr(flats[0])

    def c_entry(codec, leaves):
        """The C entry alone on `leaves` (indices into the six), its table
        built once."""
        work = [(flats[i], refs[i].reshape(-1), torch.empty_like(flats[i]),
                 leaf_topk_k(refs[i].numel()) if codec != "quant8" else 0)
                for i in leaves]
        ((fields, n, smem),) = leaf_tables(work)
        table = kernels.host_table(fields)
        return time_ms(lambda _: kernels.check_launch(lib.delta_codec_f32(
            table, n, m, CODEC_IDS[codec], smem, dev, stream),
            "delta_codec"), iters=200), n, smem

    c_entry_ms, n, smem = c_entry(codec, range(len(flats)))
    # what the radix passes cost (quant8 has none), and how much of the
    # round the widest leaf alone takes
    by_codec = {c: c_entry(c, range(len(flats)))[0]
                for c in ("quant8", "topk")}
    widest = max(range(len(flats)), key=lambda i: flats[i].shape[1])
    by_codec[f"quant8_topk {paths[widest]} alone"] = c_entry(codec,
                                                             [widest])[0]
    kernels.LAUNCHES["delta_codec"] = saved   # check launches do not count
    plain_ms = time_ms(lambda _: plain_round(codec), iters=10, warmup=1)
    active = occupancy(smem, dev)
    d_total = sum(b.numel() for b in refs)
    # the stack and the server weights read once, the result written once;
    # per element ~8 ops (subtract, abs, max, divide, round, clip, multiply,
    # add) plus the compares of the keep set
    b_ms, b_by = bound_ms((2 * m + 1) * d_total * 4, 8 * m * d_total)
    log(f"[delta_codec] main-path round (6 leaves, M={m}, D={d_total}, "
        f"quant8_topk, one launch of {n * m} clusters x {CLUSTER} blocks, "
        f"{smem} B of shared memory a block, {active} clusters resident at "
        f"once): through the tree wrapper {ms:.4f} ms, the C entry alone "
        f"{c_entry_ms:.4f} ms; plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms "
        f"({b_by}; wrapper / bound {ms / b_ms:.1f}); no single PyTorch call "
        f"computes it")
    log("[delta_codec] the C entry alone, six leaves, other codecs: " +
        ", ".join(f"{c} {t:.4f} ms" for c, t in by_codec.items()))
    require(active >= 1, "delta_codec: no cluster fits on the card")
    return {"name": "delta_codec", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/delta_codec.cu",
            "replaces": "src/repro/kernels/delta_codec/kernel.py:81",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "c_entry_ms": c_entry_ms, "c_entry_ms_by_codec": by_codec,
            "clusters_resident": active}


def check_weighted_avg(torch, device):
    """Bitwise against the plain version (the same fma chain over the
    clients in index order, emulated exactly) at the dense
    oracle's (1250, 5) weights x the six main-path leaves, all in one
    launch as the oracle makes it, and at edge shapes (M = 40, bf16 with
    D % 8 != 0 and 16-byte words side by side, a stack 4 bytes past a
    16-byte boundary).  The JSON entry is one valued round's call, timed
    through the tree wrapper (`ms`) and through the C entry alone
    (`c_entry_ms`)."""
    from repro_torch import kernels
    from repro_torch.core.shapley_batched import prefix_weight_matrix
    from repro_torch.kernels.weighted_avg import weighted_avg, weighted_avg_ref
    from repro_torch.kernels.weighted_avg.kernel import c_args, rows_per_block
    from repro_torch.tree import tree_leaves, tree_paths

    gen = torch.Generator().manual_seed(5)
    m, r = 5, 250
    stacked, _ = _stacked_mlp(torch, device, gen, m, 0.1)
    perms = torch.stack([torch.randperm(m, generator=gen) for _ in range(r)])
    n_k = torch.randint(20, 300, (m,), generator=gen).float()
    weights = prefix_weight_matrix(perms, n_k).reshape(r * m, m).to(device)
    saved = kernels.LAUNCHES["weighted_avg"]

    def check(name, x, got, w):
        want = weighted_avg_ref(x.reshape(x.shape[0], -1), w.to(x.dtype)
                                ).reshape(got.shape)
        err = float((got.float() - want.float()).abs().max())
        require(torch.equal(got, want),
                f"weighted_avg {name}: not bitwise (max err {err})")
        log(f"[weighted_avg] {name:14s} R={w.shape[0]} M={w.shape[1]} "
            f"D={x[0].numel():6d} {str(x.dtype)[6:]}: max abs err {err:.2e}")
        return err

    got = weighted_avg(stacked, weights)
    require(kernels.LAUNCHES["weighted_avg"] == saved + 1,
            "weighted_avg: the six leaves took more than one launch")
    worst = max(check(p, x, y, weights) for p, x, y in zip(
        tree_paths(stacked), tree_leaves(stacked), tree_leaves(got)))
    del got
    w40 = torch.rand((100, 40), generator=gen)
    w40 = (w40 / w40.sum(-1, keepdim=True)).to(device)
    offset = torch.randn((1 + m * 1000,), generator=gen).to(device)
    edge_cases = [
        ({"a": torch.randn((40, 3000), generator=gen).to(device),
          "b": torch.randn((40, 10), generator=gen).to(device)}, w40),
        ({"a": torch.randn((m, 20000), generator=gen).to(device,
                                                         torch.bfloat16),
          "b": torch.randn((m, 100), generator=gen).to(device,
                                                       torch.bfloat16),
          "c": torch.randn((m, 10), generator=gen).to(device,
                                                      torch.bfloat16)},
         weights),
        ({"a": offset[1:].view(m, 1000)}, weights)]
    for tree, w in edge_cases:
        out = weighted_avg(tree, w)
        for k in tree:
            err = check(f"edge {k}", tree[k], out[k], w)
            if tree[k].dtype == torch.float32:
                worst = max(worst, err)

    # the dense oracle's weights under quarantine: rows 1 and 3 weigh
    # 2^-100, so an all-masked prefix sums to ~1e-30, which the prefix
    # weights clamp at 1e-12 (as the reference does): its weights are
    # ~7.9e-19 and its model ~1e-18 w_prev.  Bitwise the plain version.
    q_stacked, _, q_nk, q_perms = _quarantined_cohort(torch, device, gen)
    q_w = prefix_weight_matrix(q_perms.cpu(), q_nk.cpu()).reshape(
        r * m, m).to(device)
    clamped = int((q_w.sum(-1) < 1e-6).sum())
    got = weighted_avg(q_stacked, q_w)
    for path, x, y in zip(tree_paths(q_stacked), tree_leaves(q_stacked),
                          tree_leaves(got)):
        want = weighted_avg_ref(x.reshape(m, -1), q_w).reshape(y.shape)
        err = float((y - want).abs().max())
        require(torch.equal(y, want),
                f"weighted_avg quarantined {path}: not bitwise the plain "
                f"version (max err {err})")
    masked_prefixes = int(((q_perms == 1) | (q_perms == 3)).long().cumprod(
        1).sum())
    require(clamped == masked_prefixes, f"weighted_avg: {clamped} clamped "
            f"rows, {masked_prefixes} all-masked prefixes")
    log(f"[weighted_avg] quarantined walks: {clamped} of {r * m} weight rows "
        f"clamped (all-masked prefixes, weights "
        f"{float(q_w[0, 1]):.3e}); bitwise the plain version at all six "
        f"leaves")
    del got

    ms = time_ms(lambda _: weighted_avg(stacked, weights))
    flats = [x.reshape(m, -1) for x in tree_leaves(stacked)]
    outs = [torch.empty((r * m, f.shape[1]), device=device) for f in flats]
    args = c_args(list(zip(flats, outs)), weights, rows_per_block(m))
    lib = kernels.library()
    c_entry_ms = time_ms(lambda _: kernels.check_launch(
        lib.weighted_avg_f32(*args), "weighted_avg"))
    del outs
    total = {"plain_ms": 0.0, "library_ms": 0.0, "bytes": 0, "ops": 0}
    for name, x in zip(tree_paths(stacked), flats):
        leaf_ms = time_ms(lambda _: weighted_avg({"w": x}, weights))
        plain_ms = time_ms(lambda _: weighted_avg_ref(x, weights), iters=10)
        lib_ms = time_ms(lambda _: torch.matmul(weights, x))
        n_bytes = (x.numel() + weights.numel() + r * m * x.shape[1]
                   ) * x.element_size()
        n_ops = 2 * r * m * x.numel()
        b_ms, b_by = bound_ms(n_bytes, n_ops)
        for key, v in (("plain_ms", plain_ms), ("library_ms", lib_ms),
                       ("bytes", n_bytes), ("ops", n_ops)):
            total[key] += v
        log(f"[weighted_avg] {name:14s} R={r * m} M={m} D={x.shape[1]:6d}: "
            f"alone in its launch {leaf_ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"torch.matmul {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    kernels.LAUNCHES["weighted_avg"] = saved  # check launches do not count
    b_ms, b_by = bound_ms(total["bytes"], total["ops"])
    log(f"[weighted_avg] main-path valued round (6 leaves, one launch): "
        f"through the wrapper {ms:.4f} ms, the C entry alone "
        f"{c_entry_ms:.4f} ms; plain {total['plain_ms']:.4f} ms, "
        f"torch.matmul {total['library_ms']:.4f} ms (wrapper / torch.matmul "
        f"{ms / total['library_ms']:.3f}), bound {b_ms:.4f} ms ({b_by}; "
        f"wrapper / bound {ms / b_ms:.3f})")
    return {"name": "weighted_avg", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/weighted_avg.cu",
            "replaces": "src/repro/kernels/weighted_avg/kernel.py:43",
            "max_abs_err": worst, "ms": ms, "plain_ms": total["plain_ms"],
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": total["library_ms"], "c_entry_ms": c_entry_ms}


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


def drive(torch, device, cfg, label, **kw):
    """One full-width run of `cfg` on the card with the launch counters
    zeroed just before and read just after; prints per-round times, the
    Shapley share and peak memory.  `kw` go to `run_federated`."""
    import numpy as np
    from repro_torch import kernels
    from repro_torch.federated.server import run_federated
    from repro_torch.tree import tree_leaves

    torch.cuda.reset_peak_memory_stats(device)
    kernels.reset_launches()
    res = run_federated(cfg, device=device, **kw)
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
        "prefix_avg": valued, "ce_loss": valued, "cohort_gather": 0,
        "delta_codec": 0, "weighted_avg": 0, "flash_attention": 0,
        "flash_attention_bwd": 0})
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
        "prefix_avg": valued, "ce_loss": valued,
        "cohort_gather": cfg.rounds, "delta_codec": cfg.rounds,
        "weighted_avg": 0, "flash_attention": 0,
        "flash_attention_bwd": 0})
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


def count_syncs(torch, fn):
    """(fn's result, the host syncs PyTorch reports while it runs): every
    synchronizing CUDA call, counted under set_sync_debug_mode("warn")."""
    import warnings
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return out, sum("synchroniz" in str(w.message) for w in caught)


def phase_scan_path(torch, device):
    """engine="scan" at the reference's defaults (synthetic MNIST, N = 50,
    M = 5, E = B = 5, the full-width 784-200-100-10 MLP, R = 250 walks,
    greedyfed, quant8_topk, 12 rounds) against the batched engine in the
    same call: selections, bytes and the eval history equal, params and
    SVs within 1e-6; a second scan run in segments of 4 rounds equal to
    the whole run bitwise.  The engine replays under set_sync_debug_mode(
    "error").  Launches: the warm-up round's (counted when they launch)
    plus each captured graph's times its replays."""
    import dataclasses

    import numpy as np
    from repro_torch import kernels
    from repro_torch.federated.server import FLConfig, run_federated
    from repro_torch.tree import tree_leaves

    cfg = FLConfig(rounds=12, upload_codec="quant8_topk", engine="batched")
    batched, _, _ = drive(torch, device, cfg, "scan-batched")
    scan_cfg = dataclasses.replace(cfg, engine="scan")
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device)
    kernels.reset_launches()
    t_run = time.perf_counter()
    scan = run_federated(scan_cfg, device=device)
    wall = time.perf_counter() - t_run
    counted = dict(kernels.LAUNCHES)
    peak_gb = (torch.cuda.max_memory_allocated(device) - base) / 1e9
    g, n_evals = scan.graph_launches, len(scan.test_acc)
    launches = {k: counted[k] - g["round"][k] - g["eval"][k]
                + g["round"][k] * cfg.rounds + g["eval"][k] * n_evals
                for k in counted}
    seg = run_federated(scan_cfg, device=device, rounds_per_segment=4)
    _, syncs_batched = count_syncs(torch, lambda: run_federated(
        cfg, device=device))
    _, syncs_scan = count_syncs(torch, lambda: run_federated(
        scan_cfg, device=device))
    _, syncs_seg = count_syncs(torch, lambda: run_federated(
        scan_cfg, device=device, rounds_per_segment=4))

    same = all((a == b).all() for a, b in zip(scan.selections,
                                              batched.selections))
    p_err = _max_err(scan.params, batched.params)
    sv_err = float(np.abs(scan.sv_final - batched.sv_final).max())
    bitwise = p_err == 0.0 and sv_err == 0.0
    seg_same = (all((a == b).all() for a, b in zip(seg.selections,
                                                   scan.selections))
                and np.array_equal(seg.sv_final, scan.sv_final)
                and seg.test_acc == scan.test_acc
                and seg.val_loss == scan.val_loss
                and all(torch.equal(a, b) for a, b in zip(
                    tree_leaves(seg.params), tree_leaves(scan.params))))
    steady = 1e3 * sum(scan.round_time_s) / cfg.rounds
    b_mean = 1e3 * sum(batched.round_time_s[1:]) / (cfg.rounds - 1)
    for t, sel in enumerate(scan.selections):
        log(f"[scan] round {t:2d} sel {sel.tolist()}")
    log(f"[scan] 12 rounds, quant8_topk, one read-back: steady replay "
        f"{steady:.3f} ms a round (device time of the replays over the "
        f"rounds), batched {b_mean:.2f} ms a round in the same call "
        f"({b_mean / steady:.2f}x); capture (warm-up round and both "
        f"graphs) {1e3 * scan.compile_time_s:.1f} ms; draw staging "
        f"{1e3 * scan.stage_time_s:.1f} ms on the host; whole run "
        f"{1e3 * wall:.1f} ms; replays {scan.dispatches}")
    log(f"[scan] segmented (4 rounds a segment): steady replay "
        f"{1e3 * sum(seg.round_time_s) / cfg.rounds:.3f} ms a round; "
        f"equal to the whole run bitwise: {seg_same}")
    log(f"[scan] host syncs a run (set-up included), counted by "
        f"set_sync_debug_mode('warn'): batched {syncs_batched}, scan "
        f"{syncs_scan}, scan in 3 segments {syncs_seg}; between replays "
        f"none (the engine replays under 'error')")
    log(f"[scan] peak memory above the set-up {peak_gb:.3f} GB (the two "
        f"graphs' pools, the staged draws, the outputs)")
    log(f"[scan] vs batched: selections equal {same}; upload bytes "
        f"{scan.upload_bytes} vs {batched.upload_bytes}; eval history "
        f"{scan.test_acc} vs {batched.test_acc}; max param err {p_err:.2e}, "
        f"max SV err {sv_err:.2e} (bitwise {bitwise}; bound 1e-6)")
    log(f"[scan] graph launches a replay {g}; path launches {launches}")
    require(same, "scan and batched selections differ")
    require(scan.upload_bytes == batched.upload_bytes
            and scan.download_bytes == batched.download_bytes,
            "scan and batched byte counts differ")
    require(scan.test_acc == batched.test_acc
            and scan.val_loss == batched.val_loss,
            "scan and batched eval histories differ")
    require(p_err <= 1e-6 and sv_err <= 1e-6, "scan and batched disagree")
    require(seg_same, "the segmented scan differs from the whole run")
    require(scan.final_acc > 0.2, f"final accuracy {scan.final_acc} <= 0.2")
    expect_launches("scan path", launches, {
        "prefix_avg": cfg.rounds + 1, "ce_loss": cfg.rounds + 1,
        "cohort_gather": cfg.rounds + 1, "delta_codec": cfg.rounds + 1,
        "weighted_avg": 0, "flash_attention": 0,
        "flash_attention_bwd": 0})
    return launches


def phase_dense_oracle(torch, device):
    """shapley_impl="batched" on the batched engine for 4 (round-robin)
    rounds, against the streaming estimator on the same walks."""
    import numpy as np
    from repro_torch.federated.server import FLConfig

    cfg = FLConfig(rounds=4, engine="batched", shapley_impl="batched")
    dense, launches, valued = drive(torch, device, cfg, "dense")
    expect_launches("dense-oracle path", launches, {
        "prefix_avg": 0, "ce_loss": valued, "cohort_gather": cfg.rounds,
        "delta_codec": 0, "weighted_avg": valued, "flash_attention": 0,
        "flash_attention_bwd": 0})
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


def _scan_run(torch, device, cfg, **kw):
    """A scan run with the launch counters zeroed just before it and read
    just after; its path launches are the warm-up round's (counted when
    they launch) plus each captured graph's times its replays."""
    from repro_torch import kernels
    from repro_torch.federated.server import run_federated

    kernels.reset_launches()
    res = run_federated(cfg, device=device, **kw)
    counted = dict(kernels.LAUNCHES)
    g, n_evals = res.graph_launches, len(res.test_acc)
    require(g is not None, "the scan captured no graph")
    return res, {k: counted[k] - g["round"][k] - g["eval"][k]
                 + g["round"][k] * cfg.rounds + g["eval"][k] * n_evals
                 for k in counted}


def phase_faults(torch, device):
    """Fault injection and the quarantine screen at the reference's
    defaults (phase 8's config with `faults=FaultSpec()`: rate 0.1, nan /
    sign_flip / crash, scale 10; `quarantine=True`), 12 rounds on the
    loop, batched and scan engines in one call: selections, quarantined
    counts (> 0), upload bytes and eval rounds equal; scan against batched
    within 1e-6 (bitwise expected), loop against batched at 1e-4.  A NaN
    storm (rate 1, nan) on the scan for 4 rounds must leave the initial
    params bitwise, with no upload byte and all-zero SVs; the dense oracle
    under the default faults for 4 rounds must equal the port's CPU run of
    the same config (selections, counts and bytes equal, params and SVs at
    1e-4).  The scan's replay time a round is printed with and without
    hardening, two runs of each in turns, and held to no bound."""
    import dataclasses

    import numpy as np
    from repro_torch.faults import FaultSpec
    from repro_torch.federated.server import FLConfig, run_federated, setup_run
    from repro_torch.tree import tree_leaves

    base = FLConfig(rounds=12, upload_codec="quant8_topk", engine="scan")
    clean, _ = _scan_run(torch, device, base)
    cfg = dataclasses.replace(base, faults=FaultSpec(), quarantine=True)
    path = []
    loop, launches, valued = drive(torch, device, dataclasses.replace(
        cfg, engine="loop"), "faults-loop")
    expect_launches("faults loop", launches, {
        "prefix_avg": valued, "ce_loss": valued, "cohort_gather": 0,
        "delta_codec": 0, "weighted_avg": 0, "flash_attention": 0,
        "flash_attention_bwd": 0})
    path.append(launches)
    batched, launches, valued = drive(torch, device, dataclasses.replace(
        cfg, engine="batched"), "faults-batched")
    expect_launches("faults batched", launches, {
        "prefix_avg": valued, "ce_loss": valued,
        "cohort_gather": cfg.rounds, "delta_codec": cfg.rounds,
        "weighted_avg": 0, "flash_attention": 0,
        "flash_attention_bwd": 0})
    path.append(launches)
    scan, launches = _scan_run(torch, device, cfg)
    expect_launches("faults scan", launches, {
        "prefix_avg": cfg.rounds + 1, "ce_loss": cfg.rounds + 1,
        "cohort_gather": cfg.rounds + 1, "delta_codec": cfg.rounds + 1,
        "weighted_avg": 0, "flash_attention": 0,
        "flash_attention_bwd": 0})
    path.append(launches)

    runs = {"loop": loop, "batched": batched, "scan": scan}
    for name, res in runs.items():
        log(f"[faults] {name}: quarantined {res.quarantined_total}, upload "
            f"bytes {res.upload_bytes}, final acc {res.final_acc:.4f}")
    for name in ("loop", "scan"):
        res = runs[name]
        require(all((a == b).all() for a, b in zip(res.selections,
                                                   batched.selections)),
                f"faults: {name} and batched selections differ")
        require(res.quarantined_total == batched.quarantined_total,
                f"faults: {name} and batched quarantined counts differ")
        require(res.upload_bytes == batched.upload_bytes
                and res.download_bytes == batched.download_bytes,
                f"faults: {name} and batched byte counts differ")
        require([r for r, _ in res.test_acc]
                == [r for r, _ in batched.test_acc],
                f"faults: {name} and batched eval rounds differ")
        require(np.isfinite(res.final_acc), f"faults: {name} accuracy")
    require(batched.quarantined_total > 0, "faults: nothing was quarantined")
    s_p, s_sv = (_max_err(scan.params, batched.params),
                 float(np.abs(scan.sv_final - batched.sv_final).max()))
    l_p, l_sv = (_max_err(loop.params, batched.params),
                 float(np.abs(loop.sv_final - batched.sv_final).max()))
    log(f"[faults] scan vs batched: max param err {s_p:.2e}, max SV err "
        f"{s_sv:.2e} (bitwise {s_p == 0.0 and s_sv == 0.0}; bound 1e-6); "
        f"loop vs batched: {l_p:.2e}, {l_sv:.2e} (atol 1e-4)")
    require(s_p <= 1e-6 and s_sv <= 1e-6, "faults: scan and batched differ")
    require(l_p <= 1e-4 and l_sv <= 1e-4, "faults: loop and batched differ")
    # the replay time in turns (clean, hardened, hardened, clean): these
    # two more runs only time, their launches are not the path's
    scan2, _ = _scan_run(torch, device, cfg)
    clean2, _ = _scan_run(torch, device, base)
    turns = [1e3 * sum(r.round_time_s) / cfg.rounds
             for r in (clean, scan, scan2, clean2)]
    hard_ms, clean_ms = (turns[1] + turns[2]) / 2, (turns[0] + turns[3]) / 2
    log(f"[faults] scan replay a round in turns, clean / hardened / hardened "
        f"/ clean: {' / '.join(f'{t:.3f}' for t in turns)} ms; hardened "
        f"{hard_ms:.3f} against clean {clean_ms:.3f} ms "
        f"({hard_ms - clean_ms:+.3f} ms, {hard_ms / clean_ms:.3f}x); capture "
        f"{1e3 * scan.compile_time_s:.1f} ms and "
        f"{1e3 * clean.compile_time_s:.1f} ms; graph launches a replay "
        f"{scan.graph_launches}")

    storm_cfg = dataclasses.replace(base, rounds=4, faults=FaultSpec(
        rate=1.0, kinds=("nan",)), quarantine=True)
    storm, launches = _scan_run(torch, device, storm_cfg)
    path.append(launches)
    init = setup_run(storm_cfg, device=device).params
    same = all(torch.equal(a, b) for a, b in zip(tree_leaves(storm.params),
                                                 tree_leaves(init)))
    log(f"[faults] NaN storm, scan, 4 rounds: quarantined "
        f"{storm.quarantined_total}, upload bytes {storm.upload_bytes}, SV "
        f"{float(np.abs(storm.sv_final).max())}, params the initial ones "
        f"bitwise {same}")
    require(same and storm.upload_bytes == 0
            and not np.abs(storm.sv_final).any()
            and storm.quarantined_total == 4 * cfg.m,
            "faults: the NaN storm left the initial params")

    dense_cfg = FLConfig(rounds=4, engine="batched", shapley_impl="batched",
                         faults=FaultSpec(), quarantine=True)
    dense, launches, valued = drive(torch, device, dense_cfg, "faults-dense")
    expect_launches("faults dense oracle", launches, {
        "prefix_avg": 0, "ce_loss": valued,
        "cohort_gather": dense_cfg.rounds, "delta_codec": 0,
        "weighted_avg": valued, "flash_attention": 0,
        "flash_attention_bwd": 0})
    path.append(launches)
    cpu = run_federated(dense_cfg, device="cpu")
    same = all((a == b).all() for a, b in zip(dense.selections,
                                              cpu.selections))
    p_err = _max_err(dense.params, _to_device(cpu.params, device))
    sv_err = float(np.abs(dense.sv_final - cpu.sv_final).max())
    log(f"[faults] dense oracle, 4 rounds, card vs CPU: selections equal "
        f"{same}; quarantined {dense.quarantined_total} vs "
        f"{cpu.quarantined_total}; upload bytes {dense.upload_bytes} vs "
        f"{cpu.upload_bytes}; max param err {p_err:.2e}, max SV err "
        f"{sv_err:.2e} (atol 1e-4)")
    require(same and dense.quarantined_total == cpu.quarantined_total
            and dense.upload_bytes == cpu.upload_bytes
            and p_err <= 1e-4 and sv_err <= 1e-4,
            "faults: the dense oracle on the card differs from the CPU")
    return {k: sum(n[k] for n in path) for k in path[0]}


def _bitwise(torch, a, b) -> bool:
    """Two FLResults of one config agree bit for bit."""
    import numpy as np
    from repro_torch.tree import tree_leaves
    return (all((x == y).all() for x, y in zip(a.selections, b.selections))
            and a.upload_bytes == b.upload_bytes
            and a.download_bytes == b.download_bytes
            and a.shapley_evals == b.shapley_evals
            and a.quarantined_total == b.quarantined_total
            and a.test_acc == b.test_acc and a.val_loss == b.val_loss
            and np.array_equal(a.sv_final, b.sv_final)
            and all(torch.equal(x, y) for x, y in zip(
                tree_leaves(a.params), tree_leaves(b.params))))


def phase_grid(torch, device):
    """The experiment grid at the reference's defaults (phase 8's widths),
    T = 12, 9 cells in 4 partitions, segments of 4 rounds into a
    checkpoint directory: every cell bitwise its solo scan run on the
    card; a grid killed after one segment and resumed bitwise the first;
    one round graph a partition.  The "sv" partition holds greedyfed x
    seeds (0, 1) and s_fedavg, so its replicas switch strategies on the
    device.  Launches: each capture's warm-up (counted when it launches)
    plus each graph's times its replays."""
    import tempfile

    import numpy as np
    from repro_torch import kernels
    from repro_torch.federated.server import FLConfig, run_federated
    from repro_torch.grid import GridCell, GridSpec, run_grid

    base = FLConfig(rounds=12, engine="scan")
    codec = {"upload_codec": "quant8_topk"}
    cells = (GridCell("greedyfed", 0), GridCell("greedyfed", 1),
             GridCell("greedyfed", 0, codec), GridCell("greedyfed", 1, codec),
             GridCell("fedavg", 0), GridCell("fedavg", 1),
             GridCell("power_of_choice", 0),
             GridCell("power_of_choice", 1, {"eval_every": 3}),
             GridCell("s_fedavg", 0))
    spec = GridSpec(base, cells)
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        before = torch.cuda.memory_allocated(device)
        kernels.reset_launches()
        t_run = time.perf_counter()
        grid, syncs = count_syncs(torch, lambda: run_grid(
            spec, device=device, rounds_per_segment=4,
            checkpoint_dir=f"{tmp}/whole"))
        wall = time.perf_counter() - t_run
        counted = dict(kernels.LAUNCHES)
        peak_gb = (torch.cuda.max_memory_allocated(device) - before) / 1e9
        require(not grid.failures, f"grid: failed cells {grid.failures}")
        killed = run_grid(spec, device=device, rounds_per_segment=4,
                          checkpoint_dir=f"{tmp}/killed", max_segments=1)
        resumed = run_grid(spec, device=device, rounds_per_segment=4,
                           checkpoint_dir=f"{tmp}/killed")
    solos = [run_federated(c.config(base), device=device) for c in cells]

    parts = grid.partitions
    launches = dict(counted)
    for p in parts:
        require(p.graph_launches is not None, f"grid: {p.label} captured "
                "no graph")
        for name, g in p.graph_launches.items():
            for k in launches:
                launches[k] += g[k] * (p.replays[name] - 1)
    for p in parts:
        solo_ms = sum(1e3 * sum(solos[i].round_time_s) / base.rounds
                      for i in p.cell_indices)
        log(f"[grid] partition {p.label}: cells {list(p.cell_indices)}, "
            f"replays {p.replays}, replay {1e3 * p.round_time_s:.3f} ms a "
            f"round against {solo_ms:.3f} ms for its cells' solo replays "
            f"summed ({1e3 * p.round_time_s / solo_ms:.3f}x); capture "
            f"{1e3 * p.capture_time_s:.1f} ms, staging "
            f"{1e3 * p.stage_time_s:.1f} ms; round graph launches "
            f"{p.graph_launches['round']}")
    same = [_bitwise(torch, r, s) for r, s in zip(grid.results, solos)]
    resumed_same = (resumed is not None and all(
        _bitwise(torch, a, b) for a, b in zip(resumed.results, grid.results)))
    log(f"[grid] {len(cells)} cells, 12 rounds in 3 segments, whole grid "
        f"{1e3 * wall:.1f} ms; peak memory above the set-up {peak_gb:.3f} "
        f"GB (a solo scan: 2.109 GB, PERF.md); host syncs of the run "
        f"(set-up of the {len(cells)} cells, checkpoint writes and read-backs "
        f"included, counted by set_sync_debug_mode('warn')) {syncs}, none "
        f"between replays (the replays run under 'error')")
    log(f"[grid] each cell bitwise its solo scan run on the card: {same}; "
        f"killed after one segment and resumed, bitwise the whole grid: "
        f"{resumed_same} (first partition ran "
        f"{resumed.partitions[0].dispatches if resumed else '-'} of "
        f"{grid.n_segments} segments on resume); final accuracies "
        f"{[round(r.final_acc, 4) for r in grid.results]}")
    log(f"[grid] path launches {launches}")
    require([(p.label, p.cell_indices, p.n_strategies) for p in parts] == [
        ("sv", (0, 1, 8), 2), ("sv+quant8_topk", (2, 3), 1),
        ("plain", (4, 5), 1), ("losses", (6, 7), 1)],
        f"grid partitions {[(p.label, p.cell_indices) for p in parts]}")
    # each kernel once a replica a round: warm-up, capture and replays
    path = {k: 0 for k in launches}
    for p in parts:
        n = len(p.cell_indices)
        want = {"cohort_gather": n,
                "prefix_avg": n if p.needs_sv else 0,
                "ce_loss": n if p.needs_sv else 0,
                "delta_codec": n if p.upload_codec != "identity" else 0,
                "weighted_avg": 0, "flash_attention": 0,
                "flash_attention_bwd": 0}
        require(p.graph_launches["round"] == want and p.replays["round"]
                == base.rounds, f"grid: {p.label} is not one round graph "
                f"of {n} replicas replayed once a round")
        for k in path:
            path[k] += want[k] * (base.rounds + 1)
    require(all(same), "grid cells differ from their solo scan runs")
    require(killed is None and resumed_same
            and resumed.partitions[0].dispatches == grid.n_segments - 1,
            "the resumed grid differs from the whole grid")
    require(all(np.isfinite(r.final_acc) for r in grid.results),
            "grid: a final accuracy is not finite")
    expect_launches("grid path", launches, path)
    return launches, grid


def _grid_launches(counted: dict, grid) -> dict:
    """A grid run's path launches: each capture's warm-up (counted when it
    launched) plus each graph's times its further replays."""
    launches = dict(counted)
    for p in grid.partitions:
        for name, g in (p.graph_launches or {}).items():
            for k in launches:
                launches[k] += g[k] * (p.replays[name] - 1)
    return launches


def phase_telemetry(torch, device, grid_ref):
    """Telemetry on phase 8's scan (N = 50, M = 5, the 784-200-100-10 MLP,
    R = 250, 12 rounds, quant8_topk), on the loop and batched engines and
    on phase 13's grid.  The scan runs off, with a file sink, with the live
    tap and with a capture window (`trace_dir`: the round captured as one
    graph a stage between CUDA timing events): all four bitwise, every
    stream valid.  Printed, held to no bound: the replay time a round off
    against the host sink and against the live tap, two turns in one call;
    the `profile` event's stage seconds and source, the round's cost card
    and the compile seconds.  The loop and batched engines with a sink are
    bitwise their runs without one, their `round_metrics` the scan's in
    selections and bytes.  Phase 13's grid with a sink, in segments of 4
    into a fresh checkpoint directory, killed after one segment and
    resumed, is bitwise phase 13's grid cell for cell, with each cell's
    `round_metrics` covering rounds 0..11.  Liveness: a one-cell grid of
    the scan in one segment with the live tap must emit at least half of
    its 12 taps before its `segment_end`.  prefix_avg, ce_loss,
    cohort_gather and delta_codec must launch on this path."""
    import dataclasses
    import tempfile

    from repro_torch import kernels
    from repro_torch.federated.server import FLConfig
    from repro_torch.grid import GridCell, GridSpec, run_grid
    from repro_torch.telemetry import Telemetry, read_events, validate_events

    cfg = FLConfig(rounds=12, upload_codec="quant8_topk", engine="scan")
    path = {k: 0 for k in kernels.LAUNCHES}

    def add(launches):
        for k in path:
            path[k] += launches[k]

    def streamed(tmp, name, **kw):
        return Telemetry(f"{tmp}/{name}.jsonl", heartbeat_every_s=1e9, **kw)

    def checked(tel):
        tel.close()
        events = read_events(tel.path)
        require(validate_events(events) == len(events) > 0,
                f"telemetry: {tel.path} does not validate")
        return events

    with tempfile.TemporaryDirectory() as tmp:
        runs, streams, times = {}, {}, {"off": [], "host": [], "live": []}
        captures = {}
        for turn in range(2):
            for mode, kw in (("off", {}), ("host", {}),
                             ("live", {"live_tap": True}),
                             ("trace", {"trace_dir": f"{tmp}/trace"})):
                if turn and mode == "trace":
                    continue
                tel = (None if mode == "off"
                       else streamed(tmp, f"{mode}{turn}", **kw))
                res, launches = _scan_run(torch, device, cfg, telemetry=tel)
                add(launches)
                captures.setdefault(mode, []).append(
                    round(1e3 * res.compile_time_s, 1))
                if mode in times:
                    times[mode].append(1e3 * sum(res.round_time_s)
                                       / cfg.rounds)
                if turn == 0:
                    runs[mode] = res
                    streams[mode] = checked(tel) if tel is not None else []
                elif tel is not None:
                    checked(tel)
        for mode in ("host", "live", "trace"):
            require(_bitwise(torch, runs[mode], runs["off"]),
                    f"telemetry: the {mode} scan differs from the run "
                    "without telemetry")
        taps = [e for e in streams["live"] if e["event"] == "round_tap"]
        require(sorted(e["round"] for e in taps) == list(range(cfg.rounds))
                and all(e["origin"] == "device" for e in taps),
                f"telemetry: taps {[e['round'] for e in taps]}")
        for e in taps:
            t = e["round"]
            require(e["selections"] == runs["off"].selections[t].tolist(),
                    f"telemetry: tap {t} selections differ from the run's")
        prof = [e for e in streams["trace"] if e["event"] == "profile"]
        comp = [e for e in streams["host"] if e["event"] == "compile"]
        require(len(prof) == 1 and len(comp) == 1,
                "telemetry: no profile or compile event")
        log(f"[telemetry] scan off / host sink / live tap / capture window: "
            f"bitwise equal; taps {len(taps)} of {cfg.rounds} rounds")
        log(f"[telemetry] replay a round, two turns in this call (ms): off "
            f"{[round(x, 3) for x in times['off']]}, host sink "
            f"{[round(x, 3) for x in times['host']]}, live tap "
            f"{[round(x, 3) for x in times['live']]}")
        log(f"[telemetry] profile: source {prof[0]['source']}, captured "
            f"{prof[0]['captured']}, stage seconds {prof[0]['stage_wall_s']}"
            f"; replays' device time {sum(runs['trace'].round_time_s):.6f} s")
        log(f"[telemetry] compile event {comp[0]['seconds']:.4f} s (kernel "
            f"build inside the run and the capture; the host sink's first "
            f"run also counts the round's FLOPs in its warm-up); cost card "
            f"{json.dumps(comp[0]['cost_card'])}; capture ms by mode and "
            f"turn {captures}")

        # the host engines with a sink, against their runs without one
        scan_rounds = [e for e in streams["host"]
                       if e["event"] == "round_metrics"]
        for engine in ("loop", "batched"):
            ecfg = dataclasses.replace(cfg, engine=engine)
            off, launches, _ = drive(torch, device, ecfg, f"tel-{engine}")
            add(launches)
            tel = streamed(tmp, engine)
            on, launches, _ = drive(torch, device, ecfg, f"tel-{engine}-sink",
                                    telemetry=tel)
            add(launches)
            rounds = [e for e in checked(tel) if e["event"] == "round_metrics"]
            require(_bitwise(torch, on, off) and on.dispatches == off.dispatches,
                    f"telemetry: {engine} with a sink differs")
            require([(e["selections"], e["upload_bytes"], e["download_bytes"])
                     for e in rounds]
                    == [(e["selections"], e["upload_bytes"], e["download_bytes"])
                        for e in scan_rounds],
                    f"telemetry: {engine} round_metrics differ from the scan's")
            log(f"[telemetry] {engine}: bitwise its run without a sink, "
                f"round_metrics equal to the scan's in selections and bytes")

        # phase 13's grid with a sink, killed after one segment and resumed
        spec = grid_ref.spec
        tel = streamed(tmp, "grid")
        kernels.reset_launches()
        killed = run_grid(spec, device=device, rounds_per_segment=4,
                          checkpoint_dir=f"{tmp}/grid", max_segments=1,
                          telemetry=tel)
        resumed = run_grid(spec, device=device, rounds_per_segment=4,
                           checkpoint_dir=f"{tmp}/grid", telemetry=tel)
        add(_grid_launches(dict(kernels.LAUNCHES), resumed))
        events = checked(tel)
        per_cell = {}
        for e in events:
            if e["event"] == "round_metrics":
                per_cell.setdefault(e["cell"], []).append(e["round"])
        kinds = [e["event"] for e in events]
        same = [_bitwise(torch, a, b)
                for a, b in zip(resumed.results, grid_ref.results)]
        log(f"[telemetry] grid with a sink, killed after one segment and "
            f"resumed: cells bitwise phase 13's {same}; events "
            f"{ {k: kinds.count(k) for k in sorted(set(kinds))} }")
        require(killed is None and all(same),
                "telemetry: the observed grid differs from phase 13's")
        require(all(per_cell.get(i) == list(range(cfg.rounds))
                    for i in range(len(spec.cells))),
                f"telemetry: per-cell rounds {per_cell}")
        require(kinds.count("run_start") == 2 and "checkpoint_save" in kinds
                and "checkpoint_load" in kinds
                and kinds.count("segment_start") == kinds.count("segment_end"),
                "telemetry: grid stream incomplete")

        # liveness: one segment of 12 rounds with the live tap
        one = GridSpec(cfg, (GridCell("greedyfed", 0),))
        tel = streamed(tmp, "liveness", live_tap=True)
        kernels.reset_launches()
        live_grid = run_grid(one, device=device, telemetry=tel)
        add(_grid_launches(dict(kernels.LAUNCHES), live_grid))
        events = checked(tel)
        end = [e["t_s"] for e in events if e["event"] == "segment_end"]
        start = [e["t_s"] for e in events if e["event"] == "segment_start"]
        taps = [e["t_s"] for e in events if e["event"] == "round_tap"]
        early = sum(t < end[0] for t in taps)
        log(f"[telemetry] liveness, one 12-round segment: {early} of "
            f"{len(taps)} taps before segment_end (segment {start[0]:.4f} to "
            f"{end[0]:.4f} s, taps at {[round(t, 4) for t in taps]})")
        require(len(end) == 1 and len(taps) == cfg.rounds
                and 2 * early >= len(taps), "telemetry: the tap is not live")
        require(_bitwise(torch, live_grid.results[0], runs["off"]),
                "telemetry: the one-cell grid differs from the solo scan")
    log(f"[telemetry] path launches {path}")
    for name in ("prefix_avg", "ce_loss", "cohort_gather", "delta_codec"):
        require(path[name] > 0, f"telemetry: {name} never launched")
    return path


def _to_device(tree, device):
    from repro_torch.tree import tree_map
    return tree_map(lambda t: t.to(device), tree)


def band_pairs(s_len: int, t_len: int, window: int) -> int:
    """Unmasked (query, key) pairs of causal attention with query and key
    positions from 0 and an optional window: the work the data needs."""
    import numpy as np
    q = np.arange(s_len, dtype=np.int64)
    hi = np.minimum(q, t_len - 1)
    lo = np.maximum(q - window + 1, 0) if window > 0 else np.zeros_like(q)
    return int(np.maximum(hi - lo + 1, 0).sum())


class Bf16AttentionError:
    """The bf16 route's error against the plain version, summed over
    slices: the max |err| (atol 3e-2), its worst share of the elementwise
    bound 5e-3 + 1e-2 |want|, and mean |err| / mean |want| (at most 5e-3).
    Rounding P to bf16 moves an output by at most 2^-8 of sum p |v| / l,
    which in rows of a few keys is ~4e-3 where the output cancels to near
    0; the relative terms hold the typical outputs (|want| ~ 0.02 at 8192
    keys), which the atol alone would not."""

    def __init__(self):
        self.max, self.share, self.err_sum, self.want_sum = 0.0, 0.0, 0.0, 0.0

    def add(self, got, want):
        got, want = got.float(), want.float()
        diff = (got - want).abs().nan_to_num(nan=math.inf)  # NaN fails
        self.max = max(self.max, float(diff.max()))
        self.share = max(self.share, float(
            (diff / (5e-3 + 1e-2 * want.abs())).max()))
        self.err_sum += float(diff.sum())
        self.want_sum += float(want.abs().sum())
        return self

    def check(self, what):
        mean_rel = self.err_sum / max(self.want_sum, 1e-30)
        require(self.max <= 3e-2 and self.share <= 1.0 and mean_rel <= 5e-3,
                f"flash_attention bf16 {what}: max err {self.max} (atol "
                f"3e-2), {self.share:.3f} of 5e-3 + 1e-2 |want|, mean err / "
                f"mean |want| {mean_rel:.2e} (at most 5e-3)")
        return (f"max abs err {self.max:.2e} (atol 3e-2), {self.share:.3f} "
                f"of 5e-3 + 1e-2 |want|, mean err / mean |want| "
                f"{mean_rel:.2e} (<= 5e-3)")


def _plain_by_heads(torch, q, k, v, window, heads=8):
    """The plain version over slices of <= `heads` query heads of the
    (B, S, Hq, hd) tensors (dense scores of all 128 heads at S = 8192
    would take 34 GB); yields (b, h0, h1, plain output (h, S, hd))."""
    from repro_torch.kernels.flash_attention import attention_ref
    b_n, _, hq, _ = q.shape
    g = hq // k.shape[2]
    for b in range(b_n):
        for h0 in range(0, hq, heads):
            h1 = min(h0 + heads, hq)
            idx = torch.arange(h0, h1, device=q.device) // g
            yield b, h0, h1, attention_ref(
                q[b, :, h0:h1].transpose(0, 1),
                k[b].index_select(1, idx).transpose(0, 1),
                v[b].index_select(1, idx).transpose(0, 1), window=window)


def _sdpa_ms(torch, q, k, v, window):
    """scaled_dot_product_attention on the same inputs with the same banded
    mask (KV repeated per group beforehand, outside the timing), under the
    first backend that takes it; (ms, backend name, output)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    g = q.shape[2] // k.shape[2]
    qh = q.transpose(1, 2)
    kh = k.transpose(1, 2).repeat_interleave(g, dim=1)
    vh = v.transpose(1, 2).repeat_interleave(g, dim=1)
    s_len, t_len = q.shape[1], k.shape[1]
    qp = torch.arange(s_len, device=q.device)[:, None]
    kp = torch.arange(t_len, device=q.device)[None, :]
    mask = kp <= qp
    if window > 0:
        mask &= kp > qp - window
    errors = []
    for backend in (SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION):
        try:
            with sdpa_kernel([backend]):
                out = F.scaled_dot_product_attention(qh, kh, vh,
                                                     attn_mask=mask)
                ms = time_ms(lambda _: F.scaled_dot_product_attention(
                    qh, kh, vh, attn_mask=mask), iters=5, warmup=1)
            return ms, backend.name, out.transpose(1, 2)
        except RuntimeError as e:
            errors.append(f"{backend.name}: {str(e).splitlines()[0]}")
    log(f"[flash_attention] no SDPA backend took the banded mask: {errors}")
    return None, None, None


# the families path's prefill layers (phase 18): (label, B, S, Hq, Kh, hd,
# window)
FAMILY_ATTENTION = (("Hymba-1.5B", 4, 8192, 25, 5, 64, 1024),
                    ("Qwen3-MoE-30B-A3B", 4, 4096, 32, 4, 128, 0),
                    ("InternVL2-76B", 4, 4096, 64, 8, 128, 0))


def check_flash_attention(torch, device):
    """Against the plain dense version at one layer's full H2O-Danube-3-4B
    prefill shape (windows 4096 and 0, bf16 and f32), at ragged and other
    head shapes, and in bf16 at the families path's prefill layers
    (`FAMILY_ATTENTION`: G = 5 with a window, G = 8 at hd 128); times
    kernel, plain version and SDPA at the main path's shape (bf16, window
    4096), whose entry is the JSON line's."""
    from repro_torch import kernels
    from repro_torch.kernels.flash_attention import flash_attention_gqa
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda

    gen = torch.Generator(device=device).manual_seed(6)
    saved = kernels.LAUNCHES["flash_attention"]
    entry, worst = None, 0.0
    b, hq, kh, s_len, hd = 4, 32, 8, 8192, 120
    base = [torch.randn(shape, generator=gen, device=device)
            for shape in ((b, s_len, hq, hd), (b, s_len, kh, hd),
                          (b, s_len, kh, hd))]
    for dtype, window in ((torch.bfloat16, 4096), (torch.bfloat16, 0),
                          (torch.float32, 4096), (torch.float32, 0)):
        q, k, v = (x.to(dtype) for x in base)
        got = flash_attention_cuda(q, k, v, window=window)
        err, bf16 = 0.0, Bf16AttentionError()
        for bb, h0, h1, want in _plain_by_heads(torch, q, k, v, window):
            out = got[bb, :, h0:h1].transpose(0, 1)
            err = max(err, float((out.float() - want.float()).abs()
                                 .nan_to_num(nan=math.inf).max()))
            if dtype == torch.bfloat16:
                bf16.add(out, want)
        if dtype == torch.bfloat16:
            verdict = bf16.check(f"window {window}")
        else:
            require(err <= 2e-5, f"flash_attention {dtype} window {window}: "
                    f"max err {err} > 2e-5")
            verdict = f"max abs err {err:.2e} (atol 2e-5)"
            worst = max(worst, err)
        ms = time_ms(lambda _: flash_attention_cuda(q, k, v, window=window),
                     iters=5, warmup=1)
        pairs = band_pairs(s_len, s_len, window) * b * hq
        n_bytes = sum(x.numel() * x.element_size() for x in (q, k, v, got))
        if dtype == torch.bfloat16:
            b_ms, b_by = bound_ms(n_bytes, 4 * hd * pairs, BF16_PEAK_FLOPS)
            b_name = ""
        else:
            # the work the f32 route does: three TF32 products a product
            b_ms, b_by = bound_ms(n_bytes, 3 * 4 * hd * pairs,
                                  TF32_PEAK_FLOPS)
            fma_ms, fma_by = bound_ms(n_bytes, 4 * hd * pairs)
            b_name = (f" (split TF32: 3 products at 495 TFLOP/s; as f32 FMA "
                      f"on the CUDA cores {fma_ms:.4f} ms, {fma_by})")
        line = (f"[flash_attention] B={b} Hq={hq} Kh={kh} S=T={s_len} "
                f"hd={hd} window={window} {str(dtype)[6:]}: {verdict}; "
                f"kernel {ms:.4f} ms "
                f"({4 * hd * pairs / ms / 1e9:.2f} TFLOP/s on {pairs} "
                f"unmasked pairs), bound {b_ms:.4f} ms ({b_by}){b_name}")
        if dtype == torch.float32 and window == 4096:
            # the f32 route's yardsticks: its plain version and f32 SDPA
            # on the same inputs
            plain_ms = time_ms(lambda _: [w for *_, w in _plain_by_heads(
                torch, q, k, v, window)], iters=1, warmup=0)
            lib_ms, backend, lib_out = _sdpa_ms(torch, q, k, v, window)
            line += f", plain {plain_ms:.4f} ms"
            f32_route = {"ms": ms, "plain_ms": plain_ms,
                         "bound_ms": b_ms, "bound_by": b_by,
                         "bound": "split TF32: 3 x 4 hd flops a pair at "
                                  "495 TFLOP/s",
                         "f32_fma_bound_ms": fma_ms,
                         "max_abs_err": err,
                         "library_ms": lib_ms,
                         "library": "scaled_dot_product_attention "
                                    f"({backend})"}
            if lib_out is not None:
                line += (f", SDPA f32 ({backend}) {lib_ms:.4f} ms (kernel / "
                         f"SDPA {ms / lib_ms:.3f})")
                del lib_out
        if entry is None:           # the main path's call: bf16, 4096
            plain_ms = time_ms(lambda _: [w for *_, w in _plain_by_heads(
                torch, q, k, v, window)], iters=1, warmup=0)
            lib_ms, backend, lib_out = _sdpa_ms(torch, q, k, v, window)
            if lib_out is not None:
                line += (f", plain {plain_ms:.4f} ms, SDPA ({backend}) "
                         f"{lib_ms:.4f} ms (kernel / SDPA {ms / lib_ms:.3f}), "
                         f"SDPA vs kernel max diff "
                         f"{float((lib_out.float() - got.float()).abs().max()):.2e}")
                del lib_out
            else:
                line += f", plain {plain_ms:.4f} ms"
            entry = {"name": "flash_attention", "route": "cuda",
                     "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
                     "replaces": "src/repro/kernels/flash_attention/kernel.py:74",
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": lib_ms,
                     "library": f"scaled_dot_product_attention ({backend})",
                     "max_abs_err": err}
        log(line)
        del q, k, v, got
        torch.cuda.empty_cache()
    del base
    for bb, s_e, hq_e, kh_e, hd_e, win in ((2, 1000, 8, 2, 64, 256),
                                           (1, 1000, 8, 2, 128, 0),
                                           (2, 777, 6, 6, 120, 100),
                                           (1, 333, 4, 4, 128, 4096)):
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = (torch.randn(shape, generator=gen, device=device
                                   ).to(dtype)
                       for shape in ((bb, s_e, hq_e, hd_e),
                                     (bb, s_e, kh_e, hd_e),
                                     (bb, s_e, kh_e, hd_e)))
            got = flash_attention_gqa(q, k, v, window=win)
            want = flash_attention_gqa(q.cpu(), k.cpu(), v.cpu(), window=win)
            what = (f"edge B={bb} S={s_e} Hq={hq_e} Kh={kh_e} hd={hd_e} "
                    f"window={win}")
            if dtype == torch.bfloat16:
                verdict = Bf16AttentionError().add(got.cpu(), want).check(what)
            else:
                err = float((got.cpu() - want).abs().max())
                require(err <= 2e-5, f"flash_attention {what} f32: max err "
                        f"{err}")
                worst = max(worst, err)
        log(f"[flash_attention] edge B={bb} S=T={s_e} Hq={hq_e} Kh={kh_e} "
            f"hd={hd_e} window={win}: f32 within atol 2e-5; bf16 {verdict}")
    for label, bb, s_e, hq_e, kh_e, hd_e, win in FAMILY_ATTENTION:
        q, k, v = (torch.randn(shape, generator=gen, device=device
                               ).to(torch.bfloat16)
                   for shape in ((bb, s_e, hq_e, hd_e), (bb, s_e, kh_e, hd_e),
                                 (bb, s_e, kh_e, hd_e)))
        got = flash_attention_cuda(q, k, v, window=win)
        bf16 = Bf16AttentionError()
        for b_i, h0, h1, want in _plain_by_heads(torch, q, k, v, win):
            bf16.add(got[b_i, :, h0:h1].transpose(0, 1), want)
        verdict = bf16.check(f"{label} layer")
        ms = time_ms(lambda _: flash_attention_cuda(q, k, v, window=win),
                     iters=5, warmup=1)
        pairs = band_pairs(s_e, s_e, win) * bb * hq_e
        n_bytes = sum(x.numel() * x.element_size() for x in (q, k, v, got))
        b_ms, b_by = bound_ms(n_bytes, 4 * hd_e * pairs, BF16_PEAK_FLOPS)
        log(f"[flash_attention] {label} layer B={bb} S=T={s_e} Hq={hq_e} "
            f"Kh={kh_e} hd={hd_e} window={win} bfloat16 (the families "
            f"path's call): {verdict}; kernel {ms:.4f} ms, bound "
            f"{b_ms:.4f} ms ({b_by}), kernel / bound {ms / b_ms:.2f}")
        del q, k, v, got
        torch.cuda.empty_cache()
    kernels.LAUNCHES["flash_attention"] = saved  # checks do not count
    log(f"[flash_attention] worst f32 error over all shapes {worst:.2e}; "
        f"the JSON entry is the main path's call (bf16, window 4096), with "
        f"the f32 route's at window 4096 under f32_route")
    entry["f32_route"] = f32_route
    return entry


def _bwd_plain_by_heads(torch, q, k, v, o, do, lse, window, causal=True,
                        q_pos=None, fn=None):
    """`attention_bwd_ref` (or `fn`, of the same arguments) over one KV
    head's group of query heads at a time, in f32 on the card (dense scores
    of all heads at S = 8192 would take tens of GB); yields (b, kv head,
    query heads h0:h1, (dq, dk, dv)) with dq (G, S, hd) and dk / dv (1, T,
    hd)."""
    from repro_torch.kernels.flash_attention import attention_bwd_ref
    fn = fn or attention_bwd_ref
    b_n, _, hq, _ = q.shape
    kh = k.shape[2]
    g = hq // kh
    f = lambda x: x.float()
    for b in range(b_n):
        for j in range(kh):
            h0, h1 = j * g, (j + 1) * g
            yield b, j, h0, h1, fn(
                f(q[b, :, h0:h1]).transpose(0, 1),
                f(k[b, :, j:j + 1]).transpose(0, 1),
                f(v[b, :, j:j + 1]).transpose(0, 1),
                f(o[b, :, h0:h1]).transpose(0, 1),
                f(do[b, :, h0:h1]).transpose(0, 1), lse[b, h0:h1],
                causal=causal, window=window, q_pos=q_pos, group=g)


def _bwd_errors(torch, got, q, k, v, o, do, lse, window, causal=True,
                q_pos=None):
    """The backward kernel's (dq, dk, dv) `got` against the plain versions,
    one KV head's group at a time: f32 against `attention_bwd_ref` at
    BwdError's rule; bf16 against `attention_bwd_bf16_ref` (its own
    arithmetic) at the same rule plus each element's flip slack, and
    against the exact `attention_bwd_ref` at the departure rule.  Returns
    the BwdErrors."""
    from repro_torch.kernels.flash_attention import (
        attention_bwd_bf16_ref, attention_bwd_bf16_slack,
    )
    dname = str(q.dtype)[6:]
    bf16 = q.dtype == torch.bfloat16

    def both(*a, **kw):           # the bf16-rounding version and its slack
        return (attention_bwd_bf16_ref(*a, **kw),
                attention_bwd_bf16_slack(*a, **kw))

    exact = BwdError(dname, departure=bf16)
    errs = [exact]
    plain = BwdError(dname) if bf16 else None
    if bf16:
        errs.insert(0, plain)
    walks = [_bwd_plain_by_heads(torch, q, k, v, o, do, lse, window, causal,
                                 q_pos)]
    if bf16:
        walks.append(_bwd_plain_by_heads(torch, q, k, v, o, do, lse, window,
                                         causal, q_pos, both))
    for parts in zip(*walks):
        bb, j, h0, h1, want = parts[0]
        mine = (got[0][bb, :, h0:h1].transpose(0, 1),
                got[1][bb, :, j:j + 1].transpose(0, 1),
                got[2][bb, :, j:j + 1].transpose(0, 1))
        exact.add(mine, want)
        if bf16:
            want_r, slack = parts[1][4]
            plain.add(mine, want_r, slack)
    return errs


class BwdError:
    """The backward's error against a plain version, element by element:
    |got - want| <= rtol |want| + atol max |want| (+ slack), with max
    |want| taken over the slice compared (one KV head's group).  f32,
    against `attention_bwd_ref`: rtol 0, atol 2e-5, the forward's 2e-5 of
    the largest gradient.  bf16, against `attention_bwd_bf16_ref` (the
    kernel's arithmetic, P and dS rounded to bf16, in f32): the kernel
    rounds each output once to bf16 (at most 2^-8 of the value), so rtol
    2^-7 on top of the same atol, plus each element's slack
    (`attention_bwd_bf16_slack`: where the kernel's f32 P or dS and the
    plain version's lie on either side of a bf16 tie, they round one bf16
    unit apart).  bf16 against the exact `attention_bwd_ref`
    (`departure`): rounding P and dS to bf16 departs by ~1.7e-3 of a
    gradient's size (measured on the CPU), held at twice that: rtol 2^-7
    and atol 2^-8 per element, and the mean |err| at 2^-8 of mean |grad|.
    `share` is the worst |got - want| over its limit (1 is at the limit);
    `scale` and `rms` are each tensor's largest and rms gradient, printed
    beside the errors."""

    def __init__(self, dtype, departure=False):
        self.departure = departure
        self.rtol = 0.0 if dtype == "float32" else 2.0 ** -7
        self.atol = 2.0 ** -8 if departure else 2e-5
        names = ("dq", "dk", "dv")
        self.err, self.share, self.scale = ({n: 0.0 for n in names}
                                            for _ in range(3))
        self._sq = {n: [0.0, 0] for n in names}
        self._abs = {n: [0.0, 0.0] for n in names}    # sum |err|, sum |want|

    def add(self, got, want, slack=None):
        for i, (name, g, w) in enumerate(zip(("dq", "dk", "dv"), got, want)):
            diff = (g.float() - w).abs().nan_to_num(nan=math.inf)
            aw = w.abs()
            top = float(aw.max())
            limit = self.rtol * aw + self.atol * top
            if slack is not None:
                limit = limit + slack[i]
            self.err[name] = max(self.err[name], float(diff.max()))
            self.share[name] = max(self.share[name], float(
                (diff / limit.clamp_min(1e-30)).max()))
            self.scale[name] = max(self.scale[name], top)
            self._sq[name][0] += float(w.double().square().sum())
            self._sq[name][1] += w.numel()
            self._abs[name][0] += float(diff.double().sum())
            self._abs[name][1] += float(aw.double().sum())

    def rms(self, name) -> float:
        total, n = self._sq[name]
        return (total / n) ** 0.5

    def mean_share(self, name) -> float:
        """mean |err| over mean |want|"""
        e, w = self._abs[name]
        return e / max(w, 1e-300)

    def worst(self) -> float:
        return max(self.share.values())

    def check(self, what):
        rule = (f"|err| <= {self.rtol:g} |grad| + {self.atol:g} max |grad|"
                + ("" if self.departure or self.rtol == 0 else " + slack"))
        require(self.worst() <= 1.0,
                f"flash_attention_bwd {what}: {rule} fails, worst share of "
                f"the limit {self.share}; errors {self.err}, max |grad| "
                f"{self.scale}")
        if self.departure:
            means = {n: self.mean_share(n) for n in self.err}
            require(max(means.values()) <= 2.0 ** -8,
                    f"flash_attention_bwd {what}: mean |err| over mean "
                    f"|grad| {means} > 2^-8")
            rule += ", mean |err| <= 2^-8 mean |grad|"
        return (f"worst err over its limit {self.worst():.3f} ({rule}; "
                + ", ".join(f"{n} err {self.err[n]:.2e}, share "
                            f"{self.share[n]:.3f}, mean err / mean |grad| "
                            f"{self.mean_share(n):.2e}, max |grad| "
                            f"{self.scale[n]:.2e}, rms {self.rms(n):.2e}"
                            for n in self.err) + ")")


def _sdpa_bwd_ms(torch, q, k, v, do, window):
    """The backward of `scaled_dot_product_attention` on the same inputs
    (KV repeated per group beforehand; causal, or the banded mask), timed
    alone after one forward: a yardstick the port never calls."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    g = q.shape[2] // k.shape[2]
    qh = q.transpose(1, 2).detach().requires_grad_()
    kh = k.transpose(1, 2).repeat_interleave(g, 1).detach().requires_grad_()
    vh = v.transpose(1, 2).repeat_interleave(g, 1).detach().requires_grad_()
    doh = do.transpose(1, 2)
    kw = {"is_causal": True}
    if window > 0:
        s_len = q.shape[1]
        qp = torch.arange(s_len, device=q.device)[:, None]
        kp = torch.arange(s_len, device=q.device)[None, :]
        kw = {"attn_mask": (kp <= qp) & (kp > qp - window)}
    errors = []
    for backend in (SDPBackend.FLASH_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION):
        try:
            # a backend that refuses the inputs warns before it raises
            with sdpa_kernel([backend]), warnings.catch_warnings():
                warnings.simplefilter("ignore", UserWarning)
                out = F.scaled_dot_product_attention(qh, kh, vh, **kw)
                ms = time_ms(lambda _: torch.autograd.grad(
                    out, (qh, kh, vh), doh, retain_graph=True), iters=5,
                    warmup=1)
            return ms, backend.name
        except RuntimeError as e:
            errors.append(f"{backend.name}: {str(e).splitlines()[0]}")
    log(f"[flash_attention_bwd] no SDPA backend took it: {errors}")
    return None, None


def check_flash_attention_bwd(torch, device):
    """The backward kernel against its plain versions on the card
    (`_bwd_errors`): the full TinyLlama layer (B = 4, S = T = 2048, Hq =
    32, Kh = 4, hd = 64, causal), the Danube layer (B = 1, Hq = 32, Kh =
    8, hd = 120, window 4096, S = 8192) and phase 20's Hymba-1.5B layer
    (B = 4, S = T = 2048, Hq = 25, Kh = 5, hd = 64, window 1024) in bf16
    and f32; ragged S, hd
    128, G = 1, non-causal and a q_pos offset.  The bf16 route's product
    kernels must hold wgmma instructions.  Two launches bitwise equal; the
    forward's output with lse bitwise the output without, its lse the
    plain log-sum-exp.
    Times kernel, plain version and SDPA's backward at the TinyLlama layer,
    whose bf16 call is the JSON entry's (the phase-15 path's call)."""
    from repro_torch import kernels
    from repro_torch.kernels.flash_attention import (
        attention_bwd_bf16_ref, attention_ref,
    )
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_bwd_cuda, flash_attention_cuda,
    )

    # both routes run only tensor-core kernels: each of their two product
    # kernels (bf16; split-TF32 f32) holds wgmma instructions at both
    # head-dim paddings
    counts = hgmma_counts(kernels.build().path)
    for name in ("bwd_dkdv_tc_kernel", "bwd_dq_tc_kernel",
                 "bwd_dkdv_f32_kernel", "bwd_dq_f32_kernel"):
        found = {f: n for f, n in counts.items() if name in f}
        require(len(found) == 2 and min(found.values()) > 0,
                f"flash_attention_bwd: {name} has no wgmma: {found}")
        by_pad = {("64" if "ILi64E" in f else "128"): n
                  for f, n in found.items()}
        log(f"[flash_attention_bwd] {name}: HGMMA instructions in SASS by "
            f"padded hd {by_pad}")
    saved = dict(kernels.LAUNCHES)
    gen = torch.Generator(device=device).manual_seed(24)
    entry, f32_route = None, None
    layers = (("TinyLlama", 4, 2048, 32, 4, 64, 0),
              ("Danube", 1, 8192, 32, 8, 120, 4096),
              ("Hymba", 4, 2048, 25, 5, 64, 1024))
    for label, b, s_len, hq, kh, hd, window in layers:
        base = [torch.randn(shape, generator=gen, device=device)
                for shape in ((b, s_len, hq, hd), (b, s_len, kh, hd),
                              (b, s_len, kh, hd), (b, s_len, hq, hd))]
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype)[6:]
            q, k, v, do = (x.to(dtype) for x in base)
            plain_o = flash_attention_cuda(q, k, v, window=window)
            o, lse = flash_attention_cuda(q, k, v, window=window,
                                          with_lse=True)
            require(torch.equal(o, plain_o), f"flash_attention {label} "
                    f"{dname}: the output with lse differs from without")
            del plain_o
            got = flash_attention_bwd_cuda(q, k, v, o, do, lse,
                                           window=window)
            again = flash_attention_bwd_cuda(q, k, v, o, do, lse,
                                             window=window)
            require(all(torch.equal(x, y) for x, y in zip(got, again)),
                    f"flash_attention_bwd {label} {dname}: two launches "
                    f"differ")
            del again
            errs = _bwd_errors(torch, got, q, k, v, o, do, lse, window)
            err, lse_err = errs[0], 0.0
            g = hq // kh
            for bb, j, h0, h1 in ((bb, j, j * g, (j + 1) * g)
                                  for bb in range(b) for j in range(kh)):
                _, want_lse = attention_ref(
                    q[bb, :, h0:h1].transpose(0, 1),
                    k[bb, :, j:j + 1].transpose(0, 1).expand(g, -1, -1),
                    v[bb, :, j:j + 1].transpose(0, 1).expand(g, -1, -1),
                    window=window, with_lse=True)
                lse_err = max(lse_err, float(
                    (lse[bb, h0:h1] - want_lse).abs().max()))
            verdict = "; ".join(
                e.check(f"{label} {dname}") for e in errs)
            require(lse_err <= 1e-4, f"flash_attention {label} {dname}: "
                    f"lse max err {lse_err} > 1e-4")
            ms = time_ms(lambda _: flash_attention_bwd_cuda(
                q, k, v, o, do, lse, window=window), iters=3, warmup=1)
            pairs = band_pairs(s_len, s_len, window) * b * hq
            n_bytes = (sum(x.numel() * x.element_size()
                           for x in (q, k, v, o, do, *got))
                       + lse.numel() * 4)
            flops = 2.5 * 4 * hd * pairs
            if dtype == torch.bfloat16:
                b_ms, b_by = bound_ms(n_bytes, flops, BF16_PEAK_FLOPS)
                b_name = f"at {BF16_PEAK_FLOPS / 1e12:g} TFLOP/s"
            else:
                # f32-accurate products as phase 3's forward bounds them:
                # split TF32, three TF32 products a product
                b_ms, b_by = bound_ms(n_bytes, 3 * flops, TF32_PEAK_FLOPS)
                fma_ms, fma_by = bound_ms(n_bytes, flops)
                b_name = (f"x 3 split-TF32 products at "
                          f"{TF32_PEAK_FLOPS / 1e12:g} TFLOP/s; as f32 FMA "
                          f"on the CUDA cores {fma_ms:.4f} ms, {fma_by}")
            tc_rate = ("" if dtype == torch.bfloat16 else
                       f", {3 * 14 * hd * pairs / ms / 1e9:.2f} TFLOP/s of "
                       f"TF32 in its 3 split products")
            line = (f"[flash_attention_bwd] {label} B={b} Hq={hq} Kh={kh} "
                    f"S=T={s_len} hd={hd} window={window} {dname}: "
                    f"{verdict}; lse max err {lse_err:.2e} (atol 1e-4), "
                    f"the output with lse bitwise the output without, two "
                    f"launches bitwise equal; kernel {ms:.4f} ms "
                    f"({14 * hd * pairs / ms / 1e9:.2f} TFLOP/s of the 14 hd "
                    f"flops a pair it does, {10 * hd * pairs / ms / 1e9:.2f} "
                    f"of the bound's 10 hd{tc_rate}; {pairs} unmasked "
                    f"pairs), bound {b_ms:.4f} ms ({b_by}; 2.5 x the "
                    f"forward's {4 * hd * pairs:.4g} flops = {flops:.4g} "
                    f"{b_name}), kernel / bound {ms / b_ms:.2f}")
            if label == "Danube" and dtype == torch.float32:
                # the f32 route's yardstick at the Danube layer too
                lib_ms, backend = _sdpa_bwd_ms(torch, q, k, v, do, window)
                if lib_ms is not None:
                    line += (f", SDPA backward ({backend}) {lib_ms:.4f} ms "
                             f"(kernel / SDPA {ms / lib_ms:.3f})")
                f32_route["danube"] = {"ms": ms, "bound_ms": b_ms,
                                       "library_ms": lib_ms,
                                       "max_abs_err": max(err.err.values()),
                                       "err_share_of_limit": err.worst()}
            if label == "TinyLlama":
                # the plain version of the kernel's own arithmetic
                fn = (attention_bwd_bf16_ref if dtype == torch.bfloat16
                      else None)
                plain_ms = time_ms(lambda _: [w for *_, w in
                                              _bwd_plain_by_heads(
                    torch, q, k, v, o, do, lse, window, fn=fn)], iters=1,
                    warmup=1)
                lib_ms, backend = _sdpa_bwd_ms(torch, q, k, v, do, window)
                line += f", plain {plain_ms:.4f} ms"
                if lib_ms is not None:
                    line += (f", SDPA backward ({backend}) {lib_ms:.4f} ms "
                             f"(kernel / SDPA {ms / lib_ms:.3f})")
                rec = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                       "bound_by": b_by, "max_abs_err": max(err.err.values()),
                       "err_share_of_limit": err.worst(),
                       "max_abs_err_exact": max(errs[-1].err.values()),
                       "departure_share_of_limit": errs[-1].worst(),
                       "library_ms": lib_ms,
                       "library": "scaled_dot_product_attention backward "
                                  f"({backend})"}
                if dtype == torch.bfloat16:
                    entry = {"name": "flash_attention_bwd", "route": "cuda",
                             "source": "src/repro_torch/kernels/csrc/"
                                       "flash_attention_bwd.cu",
                             "replaces": "src/repro/models/lm/attention.py"
                                         ":56 (autodiff of the flash scan; "
                                         "no Pallas kernel)", **rec}
                else:
                    f32_route = dict(rec, bound="split TF32: 3 x 2.5 x 4 hd "
                                                "flops a pair at 495 TFLOP/s",
                                     f32_fma_bound_ms=fma_ms)
            log(line)
            del q, k, v, do, o, lse, got
            torch.cuda.empty_cache()
        del base
    # edges: ragged S, hd 128, G = 1, non-causal, a q_pos offset
    for bb, s_e, t_e, hq_e, kh_e, hd_e, causal, win, off in (
            (2, 1000, 1000, 8, 2, 128, True, 0, 0),
            (1, 777, 777, 6, 6, 120, True, 100, 0),
            (2, 500, 500, 8, 2, 64, False, 0, 0),
            (1, 300, 1300, 8, 4, 64, True, 512, 1000)):
        pos = torch.arange(off, off + s_e, device=device)
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype)[6:]
            q, k, v = (torch.randn(shape, generator=gen, device=device
                                   ).to(dtype)
                       for shape in ((bb, s_e, hq_e, hd_e),
                                     (bb, t_e, kh_e, hd_e),
                                     (bb, t_e, kh_e, hd_e)))
            do = torch.randn(q.shape, generator=gen, device=device).to(dtype)
            o, lse = flash_attention_cuda(q, k, v, pos, causal=causal,
                                          window=win, with_lse=True)
            got = flash_attention_bwd_cuda(q, k, v, o, do, lse, pos,
                                           causal=causal, window=win)
            errs = _bwd_errors(torch, got, q, k, v, o, do, lse, win, causal,
                               pos)
            what = (f"edge B={bb} S={s_e} T={t_e} Hq={hq_e} Kh={kh_e} "
                    f"hd={hd_e} causal={causal} window={win} q_pos from "
                    f"{off} {dname}")
            log(f"[flash_attention_bwd] {what}: "
                + "; ".join(e.check(what) for e in errs))
    kernels.LAUNCHES.update(saved)          # checks do not count
    entry["f32_route"] = f32_route
    return entry


def phase_serve(torch, device):
    """`serve_requests` on full-width, full-depth H2O-Danube-3-4B: B = 4
    prompts of 8192 tokens, 32 greedy steps, exact Shapley over the 4
    requests, with the launch counters zeroed just before and read just
    after (a short warm-up serve goes first)."""
    import math
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.models.lm import model as M
    from repro_torch.models.lm.config import param_count
    from repro_torch.serve import serve_requests

    cfg = get_config("h2o_danube_3_4b")
    b, s_len, gen_len = 4, 8192, 32
    gen = torch.Generator(device=device).manual_seed(0)
    t0 = time.perf_counter()
    params = M.init_params(cfg, gen, device=device)
    torch.cuda.synchronize()
    log(f"[serve] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.hd}, d_ff {cfg.d_ff}, "
        f"window {cfg.window}, {param_count(cfg)} params ({cfg.param_dtype} "
        f"params, {cfg.dtype} activations) drawn on the card in "
        f"{time.perf_counter() - t0:.2f} s")
    tokens = torch.randint(0, cfg.vocab, (b, s_len), generator=gen,
                           device=device)
    serve_requests(cfg, params, tokens[:1, :2048], 2, device=device)
    torch.cuda.reset_peak_memory_stats(device)
    kernels.reset_launches()
    res = serve_requests(cfg, params, tokens, gen_len, device=device)
    launches = dict(kernels.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    sv = res.sv.cpu().double()
    lp = res.logprob_sum.cpu()
    grand = float(lp.mean())
    log(f"[serve] B={b} S={s_len} gen_len={gen_len}: prefill "
        f"{res.prefill_s * 1e3:.2f} ms, decode {res.decode_s * 1e3:.2f} ms "
        f"({res.decode_s * 1e3 / gen_len:.3f} ms per step, "
        f"{res.tokens_per_s:.2f} tokens/s), Shapley {res.shapley_s * 1e3:.3f}"
        f" ms (share of the request batch "
        f"{100 * res.shapley_s / (res.prefill_s + res.decode_s + res.shapley_s):.3f}"
        f" %), peak memory {peak_gb:.3f} GB")
    log(f"[serve] logprob sums {lp.tolist()}; SVs {sv.tolist()} (sum "
        f"{float(sv.sum()):.6f}, grand-coalition utility {grand:.6f}); "
        f"first generated ids {res.generated[:, :8].tolist()}; launches "
        f"{launches}")
    require(launches["flash_attention"] == cfg.n_layers,
            f"serve: flash_attention launched {launches['flash_attention']} "
            f"times, expected {cfg.n_layers} (once per layer in prefill)")
    require(all(n == 0 for k, n in launches.items()
                if k != "flash_attention"), "serve: another kernel launched")
    require(tuple(res.generated.shape) == (b, gen_len)
            and int(res.generated.min()) >= 0
            and int(res.generated.max()) < cfg.vocab, "serve: bad tokens")
    require(bool(torch.isfinite(lp).all()) and float(lp.max()) <= 0.0,
            "serve: log-prob sums must be finite and <= 0")
    require(bool(torch.isfinite(sv).all()) and math.isclose(
        float(sv.sum()), grand, rel_tol=1e-5, abs_tol=1e-4),
        "serve: the SVs must sum to the grand coalition's utility")
    del params
    torch.cuda.empty_cache()
    return launches


def phase_serve_parity(torch, device):
    """Full width, 2 layers, window 1024, f32, S = 2048, B = 2: the card
    against the port's CPU path with the same weights, decode teacher-
    forced with the CPU's greedy tokens; then decode against `forward` on
    the card."""
    import dataclasses
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.interop import params_from_numpy, params_to_numpy
    from repro_torch.models.lm import model as M
    from repro_torch.serve import request_shapley

    cfg = dataclasses.replace(get_config("h2o_danube_3_4b"), n_layers=2,
                              window=1024, dtype="float32")
    b, s_len, gen_len = 2, 2048, 8
    saved = kernels.LAUNCHES["flash_attention"]
    params = M.init_params(cfg, torch.Generator(device=device).manual_seed(1),
                           device=device)
    cpu_params = params_from_numpy(params_to_numpy(params))
    tokens = torch.randint(0, cfg.vocab, (b, s_len),
                           generator=torch.Generator().manual_seed(2))
    runs = {}
    fed = None
    for name, dev, p in (("cpu", torch.device("cpu"), cpu_params),
                         ("card", device, params)):
        t0 = time.perf_counter()
        cache, lg = M.prefill_step(cfg, p, {"tokens": tokens.to(dev)},
                                   cache_len=s_len + gen_len)
        # copies: decode writes the cache in place
        kv = {k: cache[k].to("cpu", copy=True) for k in ("k", "v")}
        logits, lp_sum = [lg.cpu()], torch.zeros((b,))
        if fed is None:                   # the CPU's greedy choices
            fed = [torch.argmax(lg, -1)]
        for i in range(gen_len):
            cache, lg = M.decode_step(cfg, p, cache,
                                      {"token": fed[i].to(dev)})
            logits.append(lg.cpu())
            if len(fed) <= i + 1:
                fed.append(torch.argmax(lg, -1))
            lp = torch.log_softmax(lg.cpu(), -1)
            lp_sum += torch.gather(lp, 1, fed[i + 1][:, None])[:, 0]
        runs[name] = (kv, logits, lp_sum,
                      request_shapley(lp_sum.to(dev)).cpu())
        log(f"[serve-parity] {name}: prefill + {gen_len} decode steps in "
            f"{time.perf_counter() - t0:.2f} s")
    (kv_c, lg_c, _, sv_c), (kv_g, lg_g, _, sv_g) = runs["cpu"], runs["card"]
    kv_err = max(float((kv_g[k] - kv_c[k]).abs().max()) for k in kv_c)
    lg_err = max(float((a - b_).abs().max()) for a, b_ in zip(lg_g, lg_c))
    sv_err = float((sv_g - sv_c).abs().max())
    ok_kv = all(torch.allclose(kv_g[k], kv_c[k], atol=2e-3, rtol=2e-3)
                for k in kv_c)
    ok_lg = all(torch.allclose(a, b_, atol=2e-3, rtol=2e-3)
                for a, b_ in zip(lg_g, lg_c))
    log(f"[serve-parity] full width, 2 layers, window 1024 (cut from 24 "
        f"layers and 4096 so the CPU run is short and S > window, S % window "
        f"== 0 hold), f32, B={b}, S={s_len}: cache max err {kv_err:.2e}, "
        f"logits max err over {gen_len + 1} steps {lg_err:.2e} (atol 2e-3, "
        f"rtol 2e-3), SV max err {sv_err:.2e} (atol 1e-4)")
    require(ok_kv and ok_lg and sv_err <= 1e-4,
            "serving on the card disagrees with the CPU")

    seq = torch.cat([tokens] + [t[:, None] for t in fed[:3]], 1).to(device)
    f_err = 0.0
    for i in range(3):
        full, _ = M.forward(cfg, params, {"tokens": seq[:, :s_len + i]})
        want = full[:, -1].cpu()
        require(torch.allclose(lg_g[i], want, atol=2e-3, rtol=2e-3),
                f"card decode step {i} disagrees with forward")
        f_err = max(f_err, float((lg_g[i] - want).abs().max()))
        del full
    log(f"[serve-parity] card decode vs forward at the same position, 3 "
        f"steps: max err {f_err:.2e} (atol 2e-3, rtol 2e-3)")
    kernels.LAUNCHES["flash_attention"] = saved   # comparisons do not count
    del params
    torch.cuda.empty_cache()


def _train_run(torch, device, cfg, batch, steps, seed=0):
    """`steps` train steps of `launch/train.py`'s LM mode from `seed` on one
    fixed batch; returns (losses, params on the CPU, launches a step, ms a
    step)."""
    from repro_torch import kernels
    from repro_torch.launch.train import build_lm
    from repro_torch.tree import tree_leaves
    params, opt, step, _ = build_lm(cfg, seed, device)
    losses, per_step, times = [], [], []
    for _ in range(steps):
        kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        per_step.append(dict(kernels.LAUNCHES))
    cpu = [t.cpu() for t in tree_leaves(params)]
    del params, opt
    torch.cuda.empty_cache()
    return losses, cpu, per_step, times


def phase_train(torch, device):
    """LM training at full width and depth: TinyLlama-1.1B (22 layers,
    d_model 2048, 32 / 4 heads of 64, d_ff 5632, vocab 32000, bf16
    activations, f32 params, AdamW, remat) through `launch/train.py`'s LM
    mode from a seeded init, 3 steps on one fixed B = 4 x S = 2048 batch:
    finite, strictly falling loss; 44 flash_attention launches a step (the
    forward, then remat's recompute) and 22 flash_attention_bwd; a second
    run from the same seed bitwise equal.  Returns the first run's
    launches (its three steps)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import synth_batch
    from repro_torch.models.lm.config import param_count

    cfg = get_config("tinyllama_1_1b")
    b, s_len, steps = 4, 2048, 3
    batch = synth_batch(cfg, torch.Generator(device=device).manual_seed(7),
                        b, s_len)
    torch.cuda.reset_peak_memory_stats(device)
    losses, params, per_step, times = _train_run(torch, device, cfg, batch,
                                                 steps)
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    launches = {k: sum(d[k] for d in per_step) for k in per_step[0]}
    tokens = b * s_len
    # matmul flops: forward 2, backward 4 and remat's recompute 2 a param a
    # token for the layers, 6 for the head; attention 4 hd a pair forward
    # (twice: remat) and 2.5 x that backward
    p_layers = param_count(cfg) - 2 * cfg.vocab * cfg.d_model - cfg.d_model
    pairs = band_pairs(s_len, s_len, cfg.window) * b * cfg.n_heads
    flops = (tokens * (8 * p_layers + 6 * cfg.vocab * cfg.d_model)
             + cfg.n_layers * 4 * cfg.hd * pairs * (2 + 2.5))
    ms = sorted(times)[len(times) // 2]
    log(f"[train] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.hd}, d_ff {cfg.d_ff}, "
        f"vocab {cfg.vocab}, {param_count(cfg)} params ({cfg.param_dtype} "
        f"params, {cfg.dtype} activations, {cfg.optimizer}, remat "
        f"{cfg.remat}), B={b} S={s_len}: losses {losses}; ms a step "
        f"{[round(t, 3) for t in times]} (median {ms:.3f}, "
        f"{tokens / ms * 1e3:.1f} tokens/s); peak memory {peak_gb:.3f} GB; "
        f"step flops {flops:.4g}, {flops / BF16_PEAK_FLOPS * 1e3:.3f} ms at "
        f"989 TFLOP/s ({flops / BF16_PEAK_FLOPS * 1e3 / ms * 100:.2f} % of "
        f"the median step); launches a step {per_step}")
    require(all(math.isfinite(x) for x in losses)
            and all(a > b_ for a, b_ in zip(losses, losses[1:])),
            f"train: the loss must be finite and strictly falling: {losses}")
    for i, d in enumerate(per_step):
        require(d["flash_attention"] == 2 * cfg.n_layers
                and d["flash_attention_bwd"] == cfg.n_layers,
                f"train: step {i} launched flash_attention "
                f"{d['flash_attention']} times (expected {2 * cfg.n_layers}) "
                f"and flash_attention_bwd {d['flash_attention_bwd']} "
                f"(expected {cfg.n_layers})")
    again, params2, _, _ = _train_run(torch, device, cfg, batch, steps)
    same = again == losses and all(torch.equal(x, y)
                                   for x, y in zip(params, params2))
    log(f"[train] a second run from the same seed: losses {again}, params "
        f"bitwise equal: {same}")
    require(same, "train: a second run from the same seed differs")
    return launches


TRAIN_GRAD_RTOL = 5e-5  # phase 16: worst leaf's max err over its max |grad|


def phase_train_parity(torch, device):
    """TinyLlama's widths cut to 2 layers, f32 activations, B = 1, S =
    2048 (the flash branch): one step's loss and gradients on the card
    against the port's CPU path with the same weights.  The gradient limit
    sits between the f32 step's error and the error of the same step with
    TF32 matrix products, which is read too and must exceed it."""
    import dataclasses
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.interop import params_from_numpy, params_to_numpy
    from repro_torch.models.lm import model as M
    from repro_torch.tree import tree_leaves

    cfg = dataclasses.replace(get_config("tinyllama_1_1b"), n_layers=2,
                              dtype="float32")
    saved = dict(kernels.LAUNCHES)
    params = M.init_params(cfg, torch.Generator(device=device).manual_seed(3),
                           device=device)
    cpu_params = params_from_numpy(params_to_numpy(params))
    tokens = torch.randint(0, cfg.vocab, (1, 2048),
                           generator=torch.Generator().manual_seed(4))
    out = {}
    for name, dev, p, tf32 in (("cpu", "cpu", cpu_params, False),
                               ("card", device, params, False),
                               ("card, TF32", device, params, True)):
        t0 = time.perf_counter()
        torch.backends.cuda.matmul.allow_tf32 = tf32
        try:
            loss, grads = M.loss_and_grads(cfg, p,
                                           {"tokens": tokens.to(dev)})
            require(torch.backends.cuda.matmul.allow_tf32 == tf32,
                    "train parity: the step reset the TF32 setting")
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        out[name] = (float(loss), [g.cpu() for g in tree_leaves(grads)])
        log(f"[train-parity] {name}: loss and gradients in "
            f"{time.perf_counter() - t0:.2f} s")
    lc, gc = out["cpu"]

    def errors(name):
        lg, gg = out[name]
        rel = max(float((a - b).abs().max())
                  / max(float(b.abs().max()), 1e-30) for a, b in zip(gg, gc))
        return abs(lg - lc) / abs(lc), rel

    loss_rel, rel = errors("card")
    tf32_loss_rel, tf32_rel = errors("card, TF32")
    log(f"[train-parity] full width, 2 layers (cut from 22 so the CPU step "
        f"is short), f32, B=1, S=2048: loss card {out['card'][0]} cpu {lc} "
        f"(relative err {loss_rel:.2e}, rtol 1e-4); gradients: worst leaf "
        f"max err / max |grad| {rel:.2e} (limit {TRAIN_GRAD_RTOL:g}); the "
        f"same step with TF32 matrix products reads {tf32_rel:.2e} (loss "
        f"{tf32_loss_rel:.2e}), {tf32_rel / TRAIN_GRAD_RTOL:.1f}x the limit")
    require(loss_rel <= 1e-4 and rel <= TRAIN_GRAD_RTOL,
            "train parity: the card's step disagrees with the CPU's")
    require(tf32_rel > TRAIN_GRAD_RTOL, "train parity: the gradient limit "
            "does not tell TF32 products from f32")
    kernels.LAUNCHES.update(saved)          # comparisons do not count
    del params
    torch.cuda.empty_cache()


def phase_federated_lm(torch, device, times=None):
    """GreedyFed on an LM: `examples/federated_lm_torch.py`'s round
    functions at --d-model 512 --layers 8 --seq 2048 --batch 2
    --local-steps 2 --clients 6 --select 3 --rounds 2 (hd 128, f32: the
    flash branch's f32 route forward and backward).  The rounds' seconds
    go into `times` where a list is given."""
    import importlib.util
    from repro_torch import kernels

    spec = importlib.util.spec_from_file_location(
        "federated_lm_torch", ROOT / "examples" / "federated_lm_torch.py")
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    args = ex.parse_args(["--d-model", "512", "--layers", "8", "--seq",
                          "2048", "--batch", "2", "--local-steps", "2",
                          "--clients", "6", "--select", "3", "--rounds",
                          "2"])
    run = ex.setup(args, device)
    kernels.reset_launches()
    times = [] if times is None else times
    for t in range(args.rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sel, sv = ex.run_round(run, t)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        sv_list = None if sv is None else sv.cpu().tolist()
        log(f"[federated-lm] round {t}: selected {sel}, SVs {sv_list}, "
            f"{times[-1]:.3f} s")
        require(len(sel) == args.select and len(set(sel)) == args.select
                and all(0 <= c < args.clients for c in sel),
                f"federated LM: bad selection {sel}")
        require(sv is not None and all(math.isfinite(x) for x in sv_list),
                f"federated LM: SVs must be finite: {sv_list}")
    launches = dict(kernels.LAUNCHES)
    with torch.no_grad():
        vl = float(-ex.utility(run, run["params"]))
    log(f"[federated-lm] {run['cfg'].name} d_model {run['cfg'].d_model}, "
        f"{run['cfg'].n_layers} layers, hd {run['cfg'].hd}, "
        f"{run['cfg'].dtype}: round times {[round(x, 3) for x in times]} s, "
        f"validation loss after {args.rounds} rounds {vl:.4f}; launches "
        f"{launches}")
    require(math.isfinite(vl), "federated LM: validation loss not finite")
    require(launches["flash_attention"] > 0
            and launches["flash_attention_bwd"] > 0,
            "federated LM: both flash entries must launch")
    del run
    torch.cuda.empty_cache()
    return launches


# phase 18: (config, layers or None for full depth, B, S, flash_attention
# launches expected in the prefill); `synth_batch` draws the frontend's
# inputs (Whisper's 1500 frames, InternVL2's 256 patches)
FAMILY_SERVES = (
    ("mamba2_370m", None, 4, 8192, 0),
    ("hymba_1_5b", None, 4, 8192, 32),
    # the encoder's 1500 keys are no multiple of 512 and the decoder's
    # S <= 1024: both attend densely
    ("whisper_medium", None, 4, 448, 0),
    ("qwen3_moe_30b_a3b", 4, 4, 4096, 4),
    ("internvl2_76b", 2, 4, 4096, 2),
)


def phase_families_serve(torch, device, smi):
    """`serve_requests` on the MoE, SSM, hybrid, encoder-decoder and VLM
    configs at full width (`FAMILY_SERVES`: Mamba2 and Hymba at full
    depth, B = 4 x 8192; Whisper full, 1500 frames, 448 decoder tokens;
    Qwen3-MoE cut to 4 layers and InternVL2 to 2, B = 4 x 4096), seeded
    weights drawn on the card (f32 params, bf16 activations), 32 greedy
    decode steps: flash_attention's launches in the prefill as the table
    says, no other kernel, finite log-prob sums <= 0, SVs that sum to the
    grand coalition.  Kimi-K2 cannot run on one card (one f32 layer of its
    experts is 67.6 GB).  Returns the launches summed over the five."""
    import dataclasses
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.launch.train import synth_batch
    from repro_torch.models.lm import model as M
    from repro_torch.models.lm.config import param_count
    from repro_torch.serve import serve_requests

    gen_len, total = 32, dict.fromkeys(kernels.LAUNCHES, 0)
    for arch, layers, b, s_len, flash in FAMILY_SERVES:
        t_phase = time.perf_counter()
        cfg = get_config(arch)
        if layers:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        gen = torch.Generator(device=device).manual_seed(18)
        params = M.init_params(cfg, gen, device=device)
        batch = synth_batch(cfg, gen, b, s_len)
        front = {k: v for k, v in batch.items() if k != "tokens"}
        # warm-up: a short serve (cuBLAS handles, allocator)
        serve_requests(cfg, params, batch["tokens"][:1, :512], 2,
                       device=device, **{k: v[:1] for k, v in front.items()})
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        kernels.reset_launches()
        res = serve_requests(cfg, params, batch["tokens"], gen_len,
                             device=device, **front)
        launches = dict(kernels.LAUNCHES)
        peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
        sv, lp = res.sv.cpu().double(), res.logprob_sum.cpu()
        grand = float(lp.mean())
        enc = (f" + {cfg.encoder_layers} encoder" if cfg.encoder_layers
               else "")
        fr = "".join(f" {k}={v.shape[1]}" for k, v in front.items())
        log(f"[families] {cfg.name} ({smi}): {cfg.n_layers} layers"
            f"{' (cut)' if layers else ''}{enc}, d_model {cfg.d_model}, "
            f"{param_count(cfg)} params, B={b} S={s_len}{fr}: prefill "
            f"{res.prefill_s * 1e3:.2f} ms ({b * s_len / res.prefill_s:.1f} "
            f"tokens/s), decode {res.decode_s * 1e3 / gen_len:.3f} ms a step "
            f"({res.tokens_per_s:.2f} tokens/s), peak memory {peak_gb:.3f} "
            f"GB; launches {launches}; logprob sums {lp.tolist()}; SVs "
            f"{sv.tolist()}; phase {time.perf_counter() - t_phase:.1f} s")
        require(launches["flash_attention"] == flash,
                f"families: {cfg.name} launched flash_attention "
                f"{launches['flash_attention']} times, expected {flash}")
        require(all(n == 0 for k, n in launches.items()
                    if k != "flash_attention"),
                f"families: {cfg.name} launched another kernel")
        require(tuple(res.generated.shape) == (b, gen_len)
                and int(res.generated.min()) >= 0
                and int(res.generated.max()) < cfg.vocab,
                f"families: {cfg.name} bad tokens")
        require(bool(torch.isfinite(lp).all()) and float(lp.max()) <= 0.0,
                f"families: {cfg.name} log-prob sums must be finite and <= 0")
        require(bool(torch.isfinite(sv).all()) and math.isclose(
            float(sv.sum()), grand, rel_tol=1e-5, abs_tol=1e-4),
            f"families: {cfg.name} SVs must sum to the grand coalition")
        for k, n in launches.items():
            total[k] += n
        del params, batch, front, res
        torch.cuda.empty_cache()
    return total


# phase 19: (config, layers, B, S); full width, f32
FAMILY_PARITY = (
    ("mamba2_370m", 2, 1, 512),
    ("hymba_1_5b", 2, 1, 2048),          # the flash branch at G = 5, f32
    ("whisper_medium", 2, 1, 448),
    ("qwen3_moe_30b_a3b", 2, 1, 256),
    ("internvl2_76b", 1, 1, 320),
)
FAMILY_ATOL = FAMILY_RTOL = 2e-3         # as phase 12's serving parity


def phase_families_parity(torch, device):
    """Each family on the card against the port's CPU path with the same
    weights, f32 (`FAMILY_PARITY`: full width, the MoE with all 128
    experts, 2 layers, InternVL2 1 for the CPU's time): forward logits and
    aux, every prefill cache, and 3 teacher-forced decode steps, at atol
    and rtol `FAMILY_ATOL`."""
    import dataclasses
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.launch.train import synth_batch
    from repro_torch.models.lm import model as M
    from repro_torch.tree import tree_map

    saved = dict(kernels.LAUNCHES)
    for arch, layers, b, s_len in FAMILY_PARITY:
        t_phase = time.perf_counter()
        cfg = dataclasses.replace(get_config(arch), n_layers=layers,
                                  dtype="float32")
        if cfg.encoder_layers:
            cfg = dataclasses.replace(cfg, encoder_layers=layers)
        params = M.init_params(cfg, torch.Generator(device=device)
                               .manual_seed(19), device=device)
        cpu_params = tree_map(lambda t: t.cpu(), params)
        batch = synth_batch(cfg, torch.Generator().manual_seed(20), b,
                            s_len + 3)
        prompt = {k: v[:, :s_len] if k == "tokens" else v
                  for k, v in batch.items()}
        runs = {}
        for name, dev, p in (("cpu", torch.device("cpu"), cpu_params),
                             ("card", device, params)):
            t0 = time.perf_counter()
            on = {k: v.to(dev) for k, v in prompt.items()}
            fwd, aux = M.forward(cfg, p, on)
            cache, lg = M.prefill_step(cfg, p, on, cache_len=s_len + 8)
            # copies: decode writes the cache in place
            caches = {k: v.to("cpu", copy=True) for k, v in cache.items()
                      if k != "pos"}
            logits = [lg.cpu()]
            for i in range(3):
                cache, lg = M.decode_step(cfg, p, cache, {
                    "token": batch["tokens"][:, s_len + i].to(dev)})
                logits.append(lg.cpu())
            runs[name] = (fwd.cpu(), float(aux), caches, logits)
            log(f"[families-parity] {cfg.name} {name}: forward, prefill and "
                f"3 decode steps in {time.perf_counter() - t0:.2f} s")
            del fwd, cache
        (fc, ac, cc, lc), (fg, ag, cg, lgs) = runs["cpu"], runs["card"]
        errs = {"forward": float((fg - fc).abs().max()),
                "aux": abs(ag - ac)}
        errs.update({k: float((cg[k] - cc[k]).abs().max()) for k in cc})
        errs["decode"] = max(float((a - b_).abs().max())
                             for a, b_ in zip(lgs, lc))
        ok = (torch.allclose(fg, fc, atol=FAMILY_ATOL, rtol=FAMILY_RTOL)
              and errs["aux"] <= 1e-5
              and all(torch.allclose(cg[k], cc[k], atol=FAMILY_ATOL,
                                     rtol=FAMILY_RTOL) for k in cc)
              and all(torch.allclose(a, b_, atol=FAMILY_ATOL,
                                     rtol=FAMILY_RTOL)
                      for a, b_ in zip(lgs, lc)))
        log(f"[families-parity] {cfg.name}: {layers} layer(s) at full width"
            f"{f', {cfg.n_experts} experts' if cfg.is_moe else ''}, f32, "
            f"B={b} S={s_len}: max errors "
            f"{ {k: float(f'{v:.3g}') for k, v in errs.items()} } (atol "
            f"and rtol {FAMILY_ATOL:g}, aux 1e-5); "
            f"{time.perf_counter() - t_phase:.1f} s")
        require(ok, f"families parity: {cfg.name} on the card disagrees "
                f"with the CPU")
        del params, cpu_params, runs
        torch.cuda.empty_cache()
    kernels.LAUNCHES.update(saved)          # comparisons do not count


def phase_hybrid_train(torch, device, smi):
    """Hymba-1.5B at full width and depth (32 layers, 25 / 5 heads of 64,
    window 1024, SSM d_inner 3200, bf16 activations, f32 params, AdamW,
    remat), B = 4 x S = 2048, 3 steps on one batch through
    `launch/train.py`'s LM-mode functions, the whole run twice: a strictly
    falling loss, the two runs bitwise equal, flash_attention launched 64
    times a step (the forward and remat's recompute) and
    flash_attention_bwd 32 (the bf16 route at G = 5).  Returns the first
    run's launches."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import synth_batch
    from repro_torch.models.lm.config import param_count

    cfg = get_config("hymba_1_5b")
    b, s_len, steps = 4, 2048, 3
    batch = synth_batch(cfg, torch.Generator(device=device).manual_seed(7),
                        b, s_len)
    torch.cuda.reset_peak_memory_stats(device)
    losses, params, per_step, times = _train_run(torch, device, cfg, batch,
                                                 steps)
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    launches = {k: sum(d[k] for d in per_step) for k in per_step[0]}
    ms = sorted(times)[len(times) // 2]
    log(f"[hybrid-train] {cfg.name} ({smi}): {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.hd}, "
        f"window {cfg.window}, d_inner {cfg.d_inner}, {param_count(cfg)} "
        f"params ({cfg.param_dtype} params, {cfg.dtype} activations, "
        f"{cfg.optimizer}, remat {cfg.remat}), B={b} S={s_len}: losses "
        f"{losses}; ms a step {[round(t, 3) for t in times]} (median "
        f"{ms:.3f}, {b * s_len / ms * 1e3:.1f} tokens/s); peak memory "
        f"{peak_gb:.3f} GB; launches a step {per_step}")
    require(all(math.isfinite(x) for x in losses)
            and all(a > b_ for a, b_ in zip(losses, losses[1:])),
            f"hybrid train: the loss must be finite and strictly falling: "
            f"{losses}")
    for i, d in enumerate(per_step):
        require(d["flash_attention"] == 2 * cfg.n_layers
                and d["flash_attention_bwd"] == cfg.n_layers,
                f"hybrid train: step {i} launched flash_attention "
                f"{d['flash_attention']} times (expected "
                f"{2 * cfg.n_layers}) and flash_attention_bwd "
                f"{d['flash_attention_bwd']} (expected {cfg.n_layers})")
    again, params2, _, _ = _train_run(torch, device, cfg, batch, steps)
    same = again == losses and all(torch.equal(x, y)
                                   for x, y in zip(params, params2))
    log(f"[hybrid-train] a second run from the same seed: losses {again}, "
        f"params bitwise equal: {same}")
    require(same, "hybrid train: a second run from the same seed differs")
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
    entries = [check_prefix_avg(torch, device),
               check_ce_loss(torch, device),
               check_cohort_gather(torch, device),
               check_delta_codec(torch, device),
               check_weighted_avg(torch, device),
               check_flash_attention(torch, device),
               check_flash_attention_bwd(torch, device)]
    phase_full_width_shapley(torch, device)
    phase_reference_run(torch, device)
    paths = {"loop": phase_main_path(torch, device),
             "batched": phase_batched_path(torch, device),
             "scan": phase_scan_path(torch, device),
             "dense_oracle": phase_dense_oracle(torch, device),
             "faults": phase_faults(torch, device),
             "serve": phase_serve(torch, device)}
    phase_serve_parity(torch, device)
    paths["grid"], grid = phase_grid(torch, device)
    paths["telemetry"] = phase_telemetry(torch, device, grid)
    paths["train"] = phase_train(torch, device)
    phase_train_parity(torch, device)
    paths["federated_lm"] = phase_federated_lm(torch, device)
    t_new = time.perf_counter()
    families = phase_families_serve(torch, device, smi)
    log(f"[families] phase 18: {time.perf_counter() - t_new:.1f} s")
    t_new = time.perf_counter()
    phase_families_parity(torch, device)
    log(f"[families-parity] phase 19: {time.perf_counter() - t_new:.1f} s")
    t_new = time.perf_counter()
    hybrid = phase_hybrid_train(torch, device, smi)
    log(f"[hybrid-train] phase 20: {time.perf_counter() - t_new:.1f} s")
    paths["families"] = {k: families[k] + hybrid[k] for k in families}
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
