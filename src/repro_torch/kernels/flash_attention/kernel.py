"""Launchers of the hand-written CUDA flash_attention kernels, forward
(`kernels/csrc/flash_attention.cu`; counterpart of
`repro/kernels/flash_attention/kernel.py`) and backward.

q (B, S, Hq, hd), k/v (B, T, Kh, hd) of one dtype (float32 or bfloat16),
read through their strides (the last axis must be contiguous), and query
positions q_pos (S,) -> o (B, S, Hq, hd) in q's dtype.  Query head h reads
KV head h // (Hq // Kh).  Any head dim, by `route(dtype, hd)`: up to
`MAX_HEAD_DIM` (128) on the tensor cores as below; up to
`TC_WIDE_MAX_HEAD_DIM` (256) on the tensor cores too, both dtypes, at the
head dim padded to 256 with each dtype's arithmetic (bf16:
`flash_bf16_wide_kernel`, `bwd_dkdv_bf16_wide_kernel`,
`bwd_dq_bf16_wide_kernel`; float32: `flash_f32_wide_kernel`,
`bwd_dkdv_f32_wide_kernel`, `bwd_dq_f32_wide_kernel`); above 256 on the
CUDA cores (`csrc/flash_attention_wide.cu`, float32 throughout, the head
dim walked in chunks of 128).  Every launch above 128 is counted in
`LAUNCHES["flash_attention_wide"]` and `["flash_attention_wide_bwd"]`,
whichever kernel runs it.  S and T need not be multiples of the tiles.

Both dtypes run on the tensor cores, with Q, K and V brought in by TMA,
which needs each tensor's base 16-byte aligned and its batch, sequence and
head strides multiples of 16 bytes (8 bf16 or 4 f32 elements).  The
model's tensors meet both.  A view that does not is first copied here
into a contiguous tensor whose rows are padded to a multiple of 16 bytes,
and the same kernel then reads the copy; no other route is ever taken.
The bf16 route rounds the softmax probabilities to bf16 before
multiplying them by V, as the reference does not (it multiplies float32
probabilities).  The float32 route keeps float32 probabilities and takes
each product as three TF32 products of the operands split into a TF32
part and its remainder (hi * hi + hi * lo + lo * hi), which holds 2e-5
against the float32 plain version; `ref.py::attention_split_tf32` is that
arithmetic on the CPU.  It does not depend on
`torch.backends.cuda.matmul.allow_tf32`.

With `with_lse` the forward also returns each row's log-sum-exp, which
`flash_attention_bwd_cuda` (`csrc/flash_attention_bwd.cu`) reads to
recompute the softmax: dq, dk and dv in three kernels (D = rowsum(dO o),
then dK / dV a key block a block, then dQ a query block a block), no
atomics, so two launches on the same inputs are bitwise equal.  Both
dtypes run on the tensor cores, Q, K, V and dO brought in by TMA (a view
TMA cannot read is copied as above).  bf16 rounds P and dS to bf16
before the products that read them (`ref.py::attention_bwd_bf16_ref` is
that arithmetic); float32 takes each of the five products as three TF32
products of split operands, as the forward's float32 route does, with P
and dS in float32 (`ref.py::attention_bwd_split_tf32`).

Meta tensors take both launchers up to the launch: the same checks, the
outputs (the lse included) allocated on `meta`, nothing launched or
counted in `LAUNCHES`.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import LAUNCHES, check_launch, library, stream_ptr

_ENTRY = {torch.float32: "flash_attention_f32",
          torch.bfloat16: "flash_attention_bf16"}
_BWD_ENTRY = {torch.float32: "flash_attention_bwd_f32",
              torch.bfloat16: "flash_attention_bwd_bf16"}
_WIDE_ENTRY = {torch.float32: "flash_attention_wide_f32",
               torch.bfloat16: "flash_attention_wide_bf16"}
_WIDE_BWD_ENTRY = {torch.float32: "flash_attention_wide_bwd_f32",
                   torch.bfloat16: "flash_attention_wide_bwd_bf16"}
MAX_HEAD_DIM = 128     # the narrow tensor-core routes' in both dtypes
TC_WIDE_MAX_HEAD_DIM = 256   # the wide tensor-core routes', both dtypes
WIDE_CHUNK = 128       # the CUDA-core route's head-dim chunk (a grid z slice)
TMA_ALIGN = 16         # bytes: base address and every stepped stride


def wide(hd: int) -> bool:
    """True when head dim `hd` counts as the wide route (above 128)."""
    return hd > MAX_HEAD_DIM


def route(dtype: torch.dtype, hd: int) -> str:
    """The kernels a call of this dtype and head dim runs, both ways:
    "tc" (hd <= 128: `flash_tc_kernel` / `flash_f32_tc_kernel` and the
    backward's tensor-core kernels), "tc_wide" (128 < hd <= 256, hd padded
    to 256: `flash_bf16_wide_kernel`, `bwd_dkdv_bf16_wide_kernel`,
    `bwd_dq_bf16_wide_kernel` in bf16; `flash_f32_wide_kernel`,
    `bwd_dkdv_f32_wide_kernel`, `bwd_dq_f32_wide_kernel` in float32) or
    "cuda_cores" (above 256: `csrc/flash_attention_wide.cu`).  `dtype` is
    float32 or bfloat16; both take the same route at every head dim."""
    if hd <= MAX_HEAD_DIM:
        return "tc"
    if hd <= TC_WIDE_MAX_HEAD_DIM:
        return "tc_wide"
    return "cuda_cores"


def tma_ready(t: torch.Tensor) -> bool:
    """True when TMA can read the (B, S, H, hd) tensor `t` in place: a
    16-byte aligned base, and every stride but the head dim's, of a
    dimension longer than 1, a positive multiple of 16 bytes."""
    if t.data_ptr() % TMA_ALIGN:
        return False
    item = t.element_size()
    return all(n == 1 or (st > 0 and st * item % TMA_ALIGN == 0)
               for n, st in zip(t.shape[:3], t.stride()[:3]))


def tma_copy(t: torch.Tensor) -> torch.Tensor:
    """A copy of `t` that TMA can read: contiguous, each row padded to a
    multiple of 16 bytes, returned as the (B, S, H, hd) view of it."""
    per = TMA_ALIGN // t.element_size()
    hd = t.shape[-1]
    buf = torch.empty((*t.shape[:3], -(-hd // per) * per), dtype=t.dtype,
                      device=t.device)
    view = buf[..., :hd]
    view.copy_(t)
    return view


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """The checks both directions make of q (B, S, Hq, hd) and k / v
    (B, T, Kh, hd)."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention takes q (B, S, Hq, hd) and k/v "
                         "(B, T, Kh, hd)")
    b, s_len, hq, hd = q.shape
    t_len, kh = k.shape[1], k.shape[2]
    if q.dtype not in _ENTRY:
        raise TypeError(f"flash_attention takes float32 or bfloat16, got "
                        f"{q.dtype}")
    if k.shape != (b, t_len, kh, hd) or v.shape != k.shape:
        raise ValueError(f"k and v must both be (B, T, Kh, hd) = (B={b}, T, "
                         f"Kh, {hd}), got {tuple(k.shape)} and "
                         f"{tuple(v.shape)}")
    if kh < 1 or hq % kh:
        raise ValueError(f"query heads {hq} are not a multiple of KV heads "
                         f"{kh}")
    if hd < 1:
        raise ValueError(f"flash_attention needs a head dim, got {hd}")
    if t_len < 1:
        raise ValueError("flash_attention needs at least one key")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type not in ("cuda", "meta") or t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, not on {q.device} "
                             f"(a CUDA or meta device)")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}'s head dim must be contiguous")


def _check_grid(b: int, hq: int, hd: int, dtype: torch.dtype) -> None:
    """The launch grid's limits: heads and batch rows (times the CUDA-core
    route's head-dim chunks) on grid axes of at most 65535."""
    chunks = (-(-hd // WIDE_CHUNK) if route(dtype, hd) == "cuda_cores"
              else 1)
    if hq > 65535 or b * chunks > 65535:
        raise ValueError(f"flash_attention takes at most 65535 heads and "
                         f"65535 batch rows x head-dim chunks, got Hq={hq}, "
                         f"B={b}, chunks={chunks}")


def _positions(q_pos: Optional[torch.Tensor], q: torch.Tensor
               ) -> torch.Tensor:
    s_len = q.shape[1]
    if q_pos is None:
        q_pos = torch.arange(s_len, dtype=torch.int32, device=q.device)
    elif q_pos.shape != (s_len,):
        raise ValueError(f"q_pos must be ({s_len},), got {tuple(q_pos.shape)}")
    return q_pos.to(device=q.device, dtype=torch.int32).contiguous()


def _scale(hd: int) -> ctypes.c_float:
    return ctypes.c_float(np.float32(hd ** -0.5))   # JAX's weak-typed f32


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         q_pos: Optional[torch.Tensor] = None, *,
                         causal: bool = True, window: int = 0,
                         with_lse: bool = False):
    """Launch the kernel once on PyTorch's current stream.  Returns o, or
    (o, lse) with `with_lse`: lse (B, Hq, S) f32 is each row's
    log-sum-exp of the scaled scores, which the backward reads; o is the
    same bit for bit either way."""
    _check(q, k, v)
    b, s_len, hq, hd = q.shape
    t_len, kh = k.shape[1], k.shape[2]
    q_pos = _positions(q_pos, q)
    out = torch.empty((b, s_len, hq, hd), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, hq, s_len), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if out.numel() == 0 or q.is_meta:
        return (out, lse) if with_lse else out
    _check_grid(b, hq, hd, q.dtype)
    counter = "flash_attention_wide" if wide(hd) else "flash_attention"
    if route(q.dtype, hd) == "cuda_cores":
        entry = _WIDE_ENTRY[q.dtype]
    else:
        q, k, v = (t if tma_ready(t) else tma_copy(t) for t in (q, k, v))
        entry = _ENTRY[q.dtype]
    rc = getattr(library(), entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(),
        q_pos.data_ptr(), b, s_len, t_len, hq, kh, hd,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *out.stride()[:3], int(causal), int(window), _scale(hd),
        q.device.index, stream_ptr(q))
    check_launch(rc, counter)
    LAUNCHES[counter] += 1
    return (out, lse) if with_lse else out


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             do: torch.Tensor, lse: torch.Tensor,
                             q_pos: Optional[torch.Tensor] = None, *,
                             causal: bool = True, window: int = 0
                             ) -> tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """The backward kernel (`csrc/flash_attention_bwd.cu`: three kernels,
    one C entry a dtype) on PyTorch's current stream: (dq, dk, dv) in q's
    dtype, contiguous, from the forward's inputs, its output o, the
    upstream gradient do (both (B, S, Hq, hd)) and its lse (B, Hq, S)
    f32.  Reads q, k, v, o and do through their strides (copied here when
    TMA cannot read them).  No atomics: bitwise repeatable."""
    _check(q, k, v)
    b, s_len, hq, hd = q.shape
    t_len, kh = k.shape[1], k.shape[2]
    for name, t in (("o", o), ("do", do)):
        if tuple(t.shape) != tuple(q.shape) or t.dtype != q.dtype:
            raise ValueError(f"{name} must be {q.dtype} {tuple(q.shape)}, "
                             f"got {t.dtype} {tuple(t.shape)}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, not on {q.device}")
    if (tuple(lse.shape) != (b, hq, s_len) or lse.dtype != torch.float32
            or lse.device != q.device):
        raise ValueError(f"lse must be float32 ({b}, {hq}, {s_len}) on "
                         f"{q.device}, got {lse.dtype} {tuple(lse.shape)}")
    q_pos = _positions(q_pos, q)
    lse = lse.contiguous()
    dq, dk, dv = (torch.empty(t.shape, dtype=t.dtype, device=t.device)
                  for t in (q, k, v))
    if q.numel() == 0 or q.is_meta:
        return dq, dk, dv
    _check_grid(b, hq, hd, q.dtype)
    if route(q.dtype, hd) == "cuda_cores":
        return _wide_bwd(q, k, v, o, do, lse, q_pos, dq, dk, dv, causal,
                         window)
    q, k, v, o, do = (t if t.stride(-1) == 1 and tma_ready(t) else tma_copy(t)
                      for t in (q, k, v, o, do))
    n_qt = -(-s_len // 64)
    # (L log2 e, D) of each row, S padded to 64, and the 64-row tiles'
    # position bounds
    rows = torch.empty((b, hq, n_qt * 64, 2), dtype=torch.float32,
                       device=q.device)
    bounds = torch.empty((2 * n_qt,), dtype=torch.int32, device=q.device)
    # above 128 with G > 1: each query head's f32 share of dK and dV,
    # summed by head in a last kernel
    part = (torch.empty((2, b, t_len, hq, hd), dtype=torch.float32,
                        device=q.device)
            if wide(hd) and hq > kh else None)
    rc = getattr(library(), _BWD_ENTRY[q.dtype])(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(), q_pos.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), rows.data_ptr(), bounds.data_ptr(),
        None if part is None else part.data_ptr(), b, s_len, t_len, hq, kh,
        hd, *q.stride()[:3], *k.stride()[:3],
        *v.stride()[:3], *o.stride()[:3], *do.stride()[:3], int(causal),
        int(window), _scale(hd), q.device.index, stream_ptr(q))
    counter = "flash_attention_wide_bwd" if wide(hd) else "flash_attention_bwd"
    check_launch(rc, counter)
    LAUNCHES[counter] += 1
    return dq, dk, dv


def _wide_bwd(q, k, v, o, do, lse, q_pos, dq, dk, dv, causal, window):
    """The CUDA-core route's backward (`csrc/flash_attention_wide.cu`: D a
    row, then dQ, then dK / dV, no atomics) into the contiguous dq, dk,
    dv."""
    b, s_len, hq, hd = q.shape
    t_len, kh = k.shape[1], k.shape[2]
    o, do = (t if t.stride(-1) == 1 else t.contiguous() for t in (o, do))
    rows = torch.empty((b, hq, s_len), dtype=torch.float32, device=q.device)
    rc = getattr(library(), _WIDE_BWD_ENTRY[q.dtype])(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(), q_pos.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), rows.data_ptr(), b, s_len, t_len, hq,
        kh, hd, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *o.stride()[:3], *do.stride()[:3], int(causal), int(window),
        _scale(hd), q.device.index, stream_ptr(q))
    check_launch(rc, "flash_attention_wide_bwd")
    LAUNCHES["flash_attention_wide_bwd"] += 1
    return dq, dk, dv
