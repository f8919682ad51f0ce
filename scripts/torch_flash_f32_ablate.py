#!/usr/bin/env python3
"""Where the f32 route of flash_attention spends its time: the kernel timed
at one H2O-Danube-3-4B prefill layer (B = 4, S = T = 8192, Hq = 32, Kh =
8, hd = 120, window 4096) with one part of its work removed at a time.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 scripts/torch_flash_f32_ablate.py [--repeats 2]

Each ablation is a set of text edits to `kernels/csrc/flash_attention.cu`
(an edit that no longer matches the source raises); each variant is built
into its own directory under `kernels/_build/ablate/` and timed through
`flash_attention_cuda` by CUDA events (`chip_smoke.time_ms`), the variants
in turns, `--repeats` times.  A variant's output is wrong by design: only
its time is read.  Prints one line per time and, last, one JSON object.
Exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# name -> [(text in the source, its replacement)]
ABLATIONS = {
    "none": [],
    "no split pass": [
        ("    for (int c = 0; c < kChunks; ++c) {\n"
         "      const uint32_t a = k_s + c * L::kKChunk",
         "    for (int c = 0; c < 0; ++c) {\n"
         "      const uint32_t a = k_s + c * L::kKChunk"),
        ("    for (int m = 0; m < HD_PAD * 8 / kF32Threads; ++m) {",
         "    for (int m = 0; m < 0; ++m) {")],
    "no Q_lo K_hi^T": [
        ("      for (int ks = 0; ks < kKS; ++ks) {\n"
         "        const uint32_t col = (ks % 4) * 32;\n"
         "        wgmma_tf32_rs_n32(",
         "      for (int ks = 0; ks < 0; ++ks) {\n"
         "        const uint32_t col = (ks % 4) * 32;\n"
         "        wgmma_tf32_rs_n32(")],
    "P V as P_hi V_hi only": [
        ("          wgmma_tf32_pv_step(t, sp, 0, j, desc128(vl + 32 * j, 16, "
         "1024), 1);",
         "          if (0) wgmma_tf32_pv_step(t, sp, 0, j, "
         "desc128(vl + 32 * j, 16, 1024), 1);"),
        ("          wgmma_tf32_pv_step(t, sp, kNS, j, desc128(vh + 32 * j, "
         "16, 1024),\n",
         "          if (0) wgmma_tf32_pv_step(t, sp, kNS, j, "
         "desc128(vh + 32 * j, 16, 1024),\n")],
    "no exponentials": [
        ("        const float p = exp2f(sp[i] - ((i & 2) ? mn_b : mn_a));",
         "        const float p = sp[i] - ((i & 2) ? mn_b : mn_a);")],
}


def variant_dir(csrc: Path, build_dir: Path, name: str, edits) -> Path:
    """A copy of `csrc` with the edits made, under `build_dir`/ablate/."""
    src = (csrc / "flash_attention.cu").read_text()
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"ablation {name!r}: edit not found once: "
                               f"{old[:60]!r}")
        src = src.replace(old, new)
    out = build_dir / "ablate" / name.replace(" ", "_").replace(
        "^", "") / "csrc"
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(csrc, out)
    (out / "flash_attention.cu").write_text(src)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repeats", type=int, default=2)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("torch_flash_f32_ablate: no CUDA device is available",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    from chip_smoke import time_ms
    from repro_torch import kernels
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_cuda,
    )

    csrc, build_dir = kernels.CSRC, kernels.BUILD_DIR
    libs = {}
    for name, edits in ABLATIONS.items():
        kernels.CSRC = variant_dir(csrc, build_dir, name, edits)
        kernels.BUILD_DIR = kernels.CSRC.parent / "build"
        libs[name] = ctypes.CDLL(str(kernels.build().path))
    kernels.CSRC, kernels.BUILD_DIR = csrc, build_dir

    gen = torch.Generator(device="cuda").manual_seed(6)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda")
               for shape in ((4, 8192, 32, 120), (4, 8192, 8, 120),
                             (4, 8192, 8, 120)))
    out = {"device": torch.cuda.get_device_name(0)}
    for _ in range(args.repeats):
        for name, lib in libs.items():
            for entry, argtypes in kernels._SIGNATURES.items():
                getattr(lib, entry).argtypes = argtypes
                getattr(lib, entry).restype = ctypes.c_int
            kernels._lib = lib
            ms = time_ms(lambda _: flash_attention_cuda(q, k, v, window=4096),
                         iters=5, warmup=1)
            out.setdefault(name, []).append(ms)
            print(f"[ablate] {name}: {ms:.4f} ms", flush=True)
    kernels._lib = None
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
