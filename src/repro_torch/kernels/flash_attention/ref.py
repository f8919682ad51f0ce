"""Plain PyTorch versions of the flash_attention kernels (counterpart of
`repro/kernels/flash_attention/ref.py`): dense scores plus a mask, for the
forward, and the backward step by step."""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def _compute_dtype(x: torch.Tensor) -> torch.dtype:
    """float32 for float32 / bf16 inputs (bf16 widened first); float64
    stays float64 (gradcheck)."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _mask(s_len: int, t_len: int, q_pos: Optional[torch.Tensor], causal,
          window, device) -> torch.Tensor:
    """(S, T) True = attend; key positions 0 .. T-1, query positions
    `q_pos` (default 0 .. S-1)."""
    if q_pos is None:
        q_pos = torch.arange(s_len, device=device)
    q_pos = q_pos.to(device)[:, None]
    k_pos = torch.arange(t_len, device=device)[None, :]
    mask = torch.ones((s_len, t_len), dtype=torch.bool, device=device)
    if causal:
        mask &= k_pos <= q_pos
    if window > 0:
        mask &= k_pos > q_pos - window
    return mask


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0,
                  q_pos: Optional[torch.Tensor] = None,
                  with_lse: bool = False):
    """q (BH, S, hd); k/v (BH, T, hd) -> (BH, S, hd) in q's dtype.

    Scores in float32 (bf16 inputs widened first; float64 kept), masked
    entries set to the finite NEG_INF, softmax over T.  Key positions are
    0 .. T-1; query positions are `q_pos` (S,), by default 0 .. S-1 as in
    the reference.  With `with_lse` also returns each row's log-sum-exp
    of the masked scaled scores, (BH, S), the forward kernel's second
    output.
    """
    ct = _compute_dtype(q)
    s_len, t_len = q.shape[1], k.shape[1]
    hd = q.shape[-1]
    s = torch.einsum("bqd,bkd->bqk", q.to(ct), k.to(ct)) * hd ** -0.5
    mask = _mask(s_len, t_len, q_pos, causal, window, q.device)
    s = torch.where(mask[None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bqk,bkd->bqd", p, v.to(ct)).to(q.dtype)
    return (o, torch.logsumexp(s, dim=-1)) if with_lse else o


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
                      *, causal: bool = True, window: int = 0,
                      q_pos: Optional[torch.Tensor] = None, group: int = 1
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernel's formulas step by step: q, o, do (BH, S, hd),
    k, v (BH / group, T, hd) (row n of q reads row n // group of k and v),
    lse (BH, S) -> (dq, dk, dv) in the inputs' dtypes.

    In float32 (float64 kept), with the forward's mask:
      P = exp(scale QK^T - L) (NEG_INF where masked, so 0 there),
      dV = P^T dO,  D = rowsum(dO o),  dS = P (dO V^T - D) (0 where
      masked, as autograd of `attention_ref`'s where gives),
      dQ = scale dS K,  dK = scale dS^T Q,
    dK and dV summed over each group's rows before the cast.
    """
    ct = _compute_dtype(q)
    s_len, t_len, hd = q.shape[1], k.shape[1], q.shape[-1]
    scale = hd ** -0.5
    qf, of, dof = q.to(ct), o.to(ct), do.to(ct)
    kf = torch.repeat_interleave(k.to(ct), group, dim=0)
    vf = torch.repeat_interleave(v.to(ct), group, dim=0)
    mask = _mask(s_len, t_len, q_pos, causal, window, q.device)[None]
    s = torch.where(mask, torch.einsum("bqd,bkd->bqk", qf, kf) * scale,
                    NEG_INF)
    p = torch.exp(s - lse.to(ct)[..., None])
    dv = torch.einsum("bqk,bqd->bkd", p, dof)
    dp = torch.einsum("bqd,bkd->bqk", dof, vf)
    dl = torch.sum(dof * of, dim=-1, keepdim=True)
    ds = torch.where(mask, p * (dp - dl), 0.0)
    dq = torch.einsum("bqk,bkd->bqd", ds, kf) * scale
    dk = torch.einsum("bqk,bqd->bkd", ds, qf) * scale
    dk = dk.unflatten(0, (-1, group)).sum(1)
    dv = dv.unflatten(0, (-1, group)).sum(1)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


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
    mask = _mask(s_len, t_len, q_pos, causal, window, q.device)
    s = torch.where(mask[None], s, NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    return _split_matmul(p, v) / l.clamp_min(1e-30)
