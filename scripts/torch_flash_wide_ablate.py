#!/usr/bin/env python3
"""Where the f32 wide route of flash_attention (128 < hd <= 256, split-TF32
`wgmma`) spends its time: the forward and the backward timed at
`chip_smoke.py`'s `WIDE_LAYER` (the federated LM example at --d-model
1024: B = 2, S = T = 2048, Hq = 4, Kh = 2, hd = 256, causal) with one part
of their work removed, or one choice of their design undone, at a time.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 scripts/torch_flash_wide_ablate.py [--repeats 2]

Each ablation is a set of text edits to `kernels/csrc/flash_attention.cu`
and `flash_attention_bwd.cu` (an edit that no longer matches the source
raises); each variant is built into its own directory under
`kernels/_build/ablate_wide/` and timed through `flash_attention_cuda` and
`flash_attention_bwd_cuda` by CUDA events (`chip_smoke.time_ms`), the
variants in turns, `--repeats` times; the backward's two product kernels
are timed apart by `torch.profiler` once a variant.  ptxas's registers
and spills of the three wide kernels are printed for each variant.  A
variant that removes work gives wrong outputs by design: only its time
is read.  Prints one line per measurement and, last, one JSON object.
Exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FWD, BWD = "flash_attention.cu", "flash_attention_bwd.cu"
WIDE_KERNELS = ("flash_f32_wide_kernel", "bwd_dkdv_f32_wide_kernel",
                "bwd_dq_f32_wide_kernel")

# name -> [(file, text in the source, its replacement)]; the forward's
# edits apply past `flash_f32_wide_kernel(const`, the backward's past the
# wide route's section mark
ABLATIONS = {
    "none": [],
    "forward: Q split by a pure conversion (hoisted)": [
        (FWD, "          const float x_hi = tf32_hi_here(x);",
         "          const float x_hi = tf32_hi(x);")],
    "forward: no split pass": [
        (FWD, "    for (int m = 0; m < L::kLandBytes / 16 / kF32Threads; "
              "++m) {",
         "    for (int m = 0; m < 0; ++m) {"),
        (FWD, "    for (int m = 0; m < L::kHdPad * 8 / kF32Threads; ++m) {",
         "    for (int m = 0; m < 0; ++m) {")],
    "forward: no S products": [
        (FWD, "      for (int j = 0; j < kGroup; ++j) {\n"
              "        const int ks = g0 + j;",
         "      for (int j = 0; j < 0; ++j) {\n"
         "        const int ks = g0 + j;")],
    "forward: no P V products": [
        (FWD, "    for (int half = 0; half < kHalf / 64; ++half) {",
         "    for (int half = 0; half < 0; ++half) {")],
    "forward: no exchange barrier": [
        (FWD, "    bar_sync<1, kF32Threads>();\n#pragma unroll\n"
              "    for (int i = 0; i < kNS; ++i) {\n      const float other",
         "#pragma unroll\n    for (int i = 0; i < kNS; ++i) {\n"
         "      const float other")],
    "backward: score groups of 2 k8 steps": [
        (BWD, "constexpr int kWideGroup = 4;",
         "constexpr int kWideGroup = 2;")],
    "backward: no score products": [
        (BWD, "    for (int j = 0; j < kG; ++j) {\n"
              "      const int ks = g0 + j;",
         "    for (int j = 0; j < 0; ++j) {\n      const int ks = g0 + j;")],
    "backward: no output products": [
        (BWD, "      wide_out_block(acc, 32 * mb, x_split,",
         "      if (mb < 0) wide_out_block(acc, 32 * mb, x_split,"),
        (BWD, "      wide_out_block(acc, 32 * mb, base + L::kOffK,",
         "      if (mb < 0) wide_out_block(acc, 32 * mb, base + L::kOffK,")],
    "backward: no split pass": [
        (BWD, "    wide_split(base + L::kOffQ,",
         "    if (tid < 0) wide_split(base + L::kOffQ,"),
        (BWD, "    wide_split(base + L::kOffK,",
         "    if (tid < 0) wide_split(base + L::kOffK,")],
}
MARKS = {FWD: "flash_f32_wide_kernel(const",
         BWD: "f32 route, 128 < hd <= 256 --"}


def variant_dir(csrc: Path, build_dir: Path, name: str, edits) -> Path:
    """A copy of `csrc` with the edits made, under `build_dir`/ablate_wide/."""
    out = build_dir / "ablate_wide" / re.sub(r"\W+", "_", name) / "csrc"
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(csrc, out)
    for file, old, new in edits:
        src = (out / file).read_text()
        cut = src.index(MARKS[file])
        head, tail = src[:cut], src[cut:]
        if tail.count(old) != 1:
            raise RuntimeError(f"ablation {name!r}: edit not found once in "
                               f"{file}: {old[:60]!r}")
        (out / file).write_text(head + tail.replace(old, new))
    return out


def ptxas_lines(log: str) -> dict:
    """ptxas's registers and spills of the wide kernels, from a build log."""
    found, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = next((k for k in WIDE_KERNELS if k in m[1]), None)
        elif cur and ("registers" in line or "spill" in line):
            found.setdefault(cur, []).append(
                re.sub(r"\s+", " ", line.replace("ptxas info    :", ""))
                .strip())
    return found


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repeats", type=int, default=2)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("torch_flash_wide_ablate: no CUDA device is available",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import WIDE_LAYER, time_ms
    from repro_torch import kernels
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_bwd_cuda, flash_attention_cuda,
    )

    csrc, build_dir = kernels.CSRC, kernels.BUILD_DIR
    libs, out = {}, {"device": torch.cuda.get_device_name(0)}
    for name, edits in ABLATIONS.items():
        kernels.CSRC = variant_dir(csrc, build_dir, name, edits)
        kernels.BUILD_DIR = kernels.CSRC.parent / "build"
        built = kernels.build()
        libs[name] = ctypes.CDLL(str(built.path))
        out.setdefault(name, {})["ptxas"] = ptxas_lines(built.log)
        print(f"[ablate] {name}: ptxas {out[name]['ptxas']}", flush=True)
    kernels.CSRC, kernels.BUILD_DIR = csrc, build_dir

    b, s_len, hq, kh, hd, window = WIDE_LAYER
    gen = torch.Generator(device="cuda").manual_seed(7)
    q, k, v, do = (torch.randn(shape, generator=gen, device="cuda")
                   for shape in ((b, s_len, hq, hd), (b, s_len, kh, hd),
                                 (b, s_len, kh, hd), (b, s_len, hq, hd)))
    for rep in range(args.repeats):
        for name, lib in libs.items():
            for entry, argtypes in kernels._SIGNATURES.items():
                getattr(lib, entry).argtypes = argtypes
                getattr(lib, entry).restype = ctypes.c_int
            kernels._lib = lib
            o, lse = flash_attention_cuda(q, k, v, window=window,
                                          with_lse=True)
            fwd = time_ms(lambda _: flash_attention_cuda(q, k, v,
                                                         window=window),
                          iters=5, warmup=1)
            bwd = time_ms(lambda _: flash_attention_bwd_cuda(
                q, k, v, o, do, lse, window=window), iters=5, warmup=1)
            rec = out[name]
            rec.setdefault("forward_ms", []).append(fwd)
            rec.setdefault("backward_ms", []).append(bwd)
            line = f"[ablate] {name}: forward {fwd:.4f} ms, backward {bwd:.4f}"
            if rep == 0:
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(3):
                        flash_attention_bwd_cuda(q, k, v, o, do, lse,
                                                 window=window)
                    torch.cuda.synchronize()
                for e in prof.key_averages():
                    for kname in WIDE_KERNELS[1:]:
                        if kname in e.key and e.count:
                            rec[kname + "_ms"] = (e.device_time_total
                                                  / e.count / 1e3)
                            line += (f", {kname} "
                                     f"{rec[kname + '_ms']:.4f}")
            print(line, flush=True)
    kernels._lib = None
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
