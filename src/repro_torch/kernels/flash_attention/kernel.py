"""Launcher of the hand-written CUDA flash_attention kernel
(`kernels/csrc/flash_attention.cu`; counterpart of
`repro/kernels/flash_attention/kernel.py`).

q (B, S, Hq, hd), k/v (B, T, Kh, hd) of one dtype (float32 or bfloat16),
read through their strides (the last axis must be contiguous), and query
positions q_pos (S,) -> o (B, S, Hq, hd) in q's dtype.  Query head h reads
KV head h // (Hq // Kh).  Head dims up to 128; S and T need not be
multiples of the tiles.

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
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import LAUNCHES, check_launch, library, stream_ptr

_ENTRY = {torch.float32: "flash_attention_f32",
          torch.bfloat16: "flash_attention_bf16"}
MAX_HEAD_DIM = 128
TMA_ALIGN = 16         # bytes: base address and every stepped stride


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


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         q_pos: Optional[torch.Tensor] = None, *,
                         causal: bool = True,
                         window: int = 0) -> torch.Tensor:
    """Launch the kernel once on PyTorch's current stream."""
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
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention takes head dims 1..{MAX_HEAD_DIM}"
                         f", got {hd}")
    if t_len < 1:
        raise ValueError("flash_attention needs at least one key")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, not on {q.device} "
                             f"(a CUDA device)")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}'s head dim must be contiguous")
    if q_pos is None:
        q_pos = torch.arange(s_len, dtype=torch.int32, device=q.device)
    elif q_pos.shape != (s_len,):
        raise ValueError(f"q_pos must be ({s_len},), got {tuple(q_pos.shape)}")
    q_pos = q_pos.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty((b, s_len, hq, hd), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    if hq > 65535 or b > 65535:
        raise ValueError(f"flash_attention takes at most 65535 heads and "
                         f"batch rows, got Hq={hq}, B={b}")
    q, k, v = (t if tma_ready(t) else tma_copy(t) for t in (q, k, v))
    scale = ctypes.c_float(np.float32(hd ** -0.5))   # JAX's weak-typed f32
    rc = getattr(library(), _ENTRY[q.dtype])(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        q_pos.data_ptr(), b, s_len, t_len, hq, kh, hd,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *out.stride()[:3], int(causal), int(window), scale,
        q.device.index, stream_ptr(q))
    check_launch(rc, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return out
