#!/usr/bin/env python3
"""How far the f32 flash route's split-TF32 arithmetic lies from the exact
attention, beside plain float32, on the CPU: the forward of
`kernels/flash_attention/ref.py::attention_split_tf32` (three TF32
products a product), variants of its split, and `attention_ref` in
float32, each against float64, and the split against float32.

Run from the root of a checkout (no card needed):

    python3 scripts/flash_split_tf32_error.py

The inputs are the CPU tests' (`tests/test_torch_lm.py::_split_case`: B
1, 4 / 2 heads, causal, seeded normal q, k, v, q and k scaled alike so
that max |s| is the case's s_max), folded to (BH, S, hd) with KV repeated
per group.  The variants change only the split of each product:
"4 products" adds a_lo b_lo, "lo exact" reads a_lo and b_lo in full f32,
"lo rounded" rounds them to TF32 before the tensor core reads them.
Prints one line per case and variant: max |x - exact| and max |split -
float32|.
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
CASES = ((256, 128, 0, 30.0), (256, 160, 0, 30.0), (256, 256, 0, 30.0),
         (200, 256, 128, 30.0), (256, 256, 0, None))


def inputs(s, hd, win, s_max, b=1, hq=4, kh=2):
    """The tests' q, k, v folded to (BH, S, hd), KV repeated per group."""
    rng = np.random.default_rng(s + hd + win)
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((b, s, hq, hd), (b, s, kh, hd), (b, s, kh, hd)))
    g = hq // kh
    if s_max is not None:
        kr = np.repeat(k, g, axis=2)
        s0 = np.abs(np.einsum("bqhd,bkhd->bhqk", q, kr)).max() * hd ** -0.5
        c = np.float32(np.sqrt(s_max / s0))
        q, k = q * c, k * c
    qf = q.reshape(b, s, kh, g, hd).transpose(0, 2, 3, 1, 4).reshape(-1, s,
                                                                     hd)
    kf = np.repeat(k.transpose(0, 2, 1, 3), g, axis=1).reshape(-1, s, hd)
    vf = np.repeat(v.transpose(0, 2, 1, 3), g, axis=1).reshape(-1, s, hd)
    return (torch.from_numpy(np.ascontiguousarray(x)) for x in (qf, kf, vf))


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.flash_attention import ref

    hi, read = ref._tf32_hi, ref._tf32_read
    variants = {
        "3 products": ref._split_matmul,
        "4 products": lambda a, b: (hi(a) @ hi(b) + (
            hi(a) @ read(b - hi(b)) + read(a - hi(a)) @ hi(b)
            + read(a - hi(a)) @ read(b - hi(b)))),
        "lo exact": lambda a, b: hi(a) @ hi(b) + (
            hi(a) @ (b - hi(b)) + (a - hi(a)) @ hi(b)),
        "lo rounded": lambda a, b: hi(a) @ hi(b) + (
            hi(a) @ hi(b - hi(b)) + hi(a - hi(a)) @ hi(b)),
    }
    original = ref._split_matmul
    for s, hd, win, s_max in CASES:
        q, k, v = inputs(s, hd, win, s_max)
        exact = ref.attention_ref(q.double(), k.double(), v.double(),
                                  window=win)
        f32 = ref.attention_ref(q, k, v, window=win)
        err_f32 = float((f32.double() - exact).abs().max())
        for name, fn in variants.items():
            ref._split_matmul = fn
            got = ref.attention_split_tf32(q, k, v, window=win)
            ref._split_matmul = original
            err = float((got.double() - exact).abs().max())
            apart = float((got - f32).abs().max())
            print(f"S {s} hd {hd} window {win} max|s| {s_max}: {name}: "
                  f"{err:.3e} from float64 (float32 {err_f32:.3e}), "
                  f"{apart:.3e} from float32", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
