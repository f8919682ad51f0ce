"""Plain PyTorch version of the flash_attention kernel (counterpart of
`repro/kernels/flash_attention/ref.py`): dense scores plus a mask."""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0,
                  q_pos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q (BH, S, hd); k/v (BH, T, hd) -> (BH, S, hd) in q's dtype.

    Scores in float32 (bf16 inputs widened first), masked entries set to
    the finite NEG_INF, softmax over T.  Key positions are 0 .. T-1; query
    positions are `q_pos` (S,), by default 0 .. S-1 as in the reference.
    """
    s_len, t_len = q.shape[1], k.shape[1]
    hd = q.shape[-1]
    s = torch.einsum("bqd,bkd->bqk", q.to(torch.float32),
                     k.to(torch.float32)) * hd ** -0.5
    if q_pos is None:
        q_pos = torch.arange(s_len, device=q.device)
    q_pos = q_pos.to(q.device)[:, None]
    k_pos = torch.arange(t_len, device=q.device)[None, :]
    mask = torch.ones((s_len, t_len), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window > 0:
        mask &= k_pos > q_pos - window
    s = torch.where(mask[None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p,
                        v.to(torch.float32)).to(q.dtype)


def _tf32_hi(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits, to nearest, ties away from
    zero) and kept as float32: the kernel's `cvt.rna.tf32.f32`."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_read(x: torch.Tensor) -> torch.Tensor:
    """What the tensor core reads of a float32 operand: its top 19 bits."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _split_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the kernel's split products, a_hi b_hi + (a_hi b_lo +
    a_lo b_hi), each operand read as the tensor core reads it."""
    a_hi, b_hi = _tf32_hi(a), _tf32_hi(b)
    a_lo, b_lo = _tf32_read(a - a_hi), _tf32_read(b - b_hi)
    return a_hi @ b_hi + (a_hi @ b_lo + a_lo @ b_hi)


def attention_split_tf32(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0,
                         q_pos: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """The float32 CUDA route's arithmetic on the CPU, for the tests only:
    q (BH, S, hd); k/v (BH, T, hd) float32 -> (BH, S, hd).

    Both products are split as the kernel splits them: x = x_hi + x_lo,
    x_hi rounded to TF32, x_lo = x - x_hi exactly, the tensor core reading
    x_lo's top 19 bits, and x_lo y_lo dropped; S = Q_hi K_hi + (Q_hi K_lo
    + Q_lo K_hi), the finite NEG_INF mask, f32 p against the row max, l
    the sum of the unsplit p, o = (P_hi V_hi + (P_hi V_lo + P_lo V_hi)) /
    max(l, 1e-30).  The kernel's online softmax rescales by tile, and the
    tensor core truncates its own sums; this takes the row max at once and
    sums in f32, which differs in rounding only.
    """
    s_len, t_len = q.shape[1], k.shape[1]
    hd = q.shape[-1]
    s = _split_matmul(q, k.transpose(1, 2)) * torch.tensor(
        hd ** -0.5, dtype=torch.float32)
    if q_pos is None:
        q_pos = torch.arange(s_len)
    q_pos = q_pos[:, None]
    k_pos = torch.arange(t_len)[None, :]
    mask = torch.ones((s_len, t_len), dtype=torch.bool)
    if causal:
        mask &= k_pos <= q_pos
    if window > 0:
        mask &= k_pos > q_pos - window
    s = torch.where(mask[None], s, NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    return _split_matmul(p, v) / l.clamp_min(1e-30)
