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
    return _attention_bwd(q, k, v, o, do, lse, causal, window, q_pos, group,
                          lambda x: x)


def _bwd_terms(q, k, v, o, do, lse, causal, window, q_pos, group):
    """The backward's operands in the compute dtype, KV repeated per group
    (qf, kf, vf, of, dof), the scale, the mask (1, S, T), P, dP and D."""
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
    dp = torch.einsum("bqd,bkd->bqk", dof, vf)
    dl = torch.sum(dof * of, dim=-1, keepdim=True)
    return qf, kf, vf, of, dof, scale, mask, p, dp, dl


def _attention_bwd(q, k, v, o, do, lse, causal, window, q_pos, group, rnd):
    """`attention_bwd_ref`'s formulas with `rnd` applied to P and dS where
    the products read them."""
    qf, kf, vf, of, dof, scale, mask, p, dp, dl = _bwd_terms(
        q, k, v, o, do, lse, causal, window, q_pos, group)
    dv = torch.einsum("bqk,bqd->bkd", rnd(p), dof)
    ds = torch.where(mask, p * (dp - dl), 0.0)
    dq = torch.einsum("bqk,bkd->bqd", rnd(ds), kf) * scale
    dk = torch.einsum("bqk,bqd->bkd", rnd(ds), qf) * scale
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


def attention_bwd_split_tf32(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             do: torch.Tensor, lse: torch.Tensor, *,
                             causal: bool = True, window: int = 0,
                             q_pos: Optional[torch.Tensor] = None,
                             group: int = 1
                             ) -> tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """The float32 CUDA route's backward arithmetic on the CPU, for the
    tests only: `attention_bwd_ref` (same arguments and layout, float32)
    with each of its five products split as the kernels split them
    (`_split_matmul`): S = Q K^T, dP = dO V^T, dV = P^T dO, dQ = dS K and
    dK = dS^T Q, each as a_hi b_hi + (a_hi b_lo + a_lo b_hi).  P, dS, D,
    L, the scale and the sums over a group's heads stay float32.  The
    kernels' tensor cores truncate their own sums, which this does not
    emulate (they keep each such sum short)."""
    s_len, t_len, hd = q.shape[1], k.shape[1], q.shape[-1]
    scale = torch.tensor(hd ** -0.5, dtype=torch.float32)
    kf = torch.repeat_interleave(k, group, dim=0)
    vf = torch.repeat_interleave(v, group, dim=0)
    mask = _mask(s_len, t_len, q_pos, causal, window, q.device)[None]
    s = torch.where(mask, _split_matmul(q, kf.transpose(1, 2)) * scale,
                    NEG_INF)
    p = torch.exp(s - lse[..., None])
    dp = _split_matmul(do, vf.transpose(1, 2))
    dl = torch.sum(do * o, dim=-1, keepdim=True)
    ds = torch.where(mask, p * (dp - dl), 0.0)
    dv = _split_matmul(p.transpose(1, 2), do)
    dq = _split_matmul(ds, kf) * scale
    dk = _split_matmul(ds.transpose(1, 2), q) * scale
    return (dq, dk.unflatten(0, (-1, group)).sum(1),
            dv.unflatten(0, (-1, group)).sum(1))


def _round_bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16 (to nearest, ties to even) and kept in x's dtype."""
    return x.to(torch.bfloat16).to(x.dtype)


def attention_bwd_bf16_ref(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, o: torch.Tensor,
                           do: torch.Tensor, lse: torch.Tensor, *,
                           causal: bool = True, window: int = 0,
                           q_pos: Optional[torch.Tensor] = None,
                           group: int = 1
                           ) -> tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """The bf16 CUDA route's backward arithmetic on the CPU, for the tests:
    `attention_bwd_ref` (same arguments and layout) with P and dS rounded
    to bf16 before the products that read them, dV = bf16(P)^T dO, dQ =
    scale bf16(dS) K and dK = scale bf16(dS)^T Q, and every sum in float32
    (dS itself from the unrounded P).  The kernel's sums run in another
    order, partly inside the tensor core, so where P or dS lies at a bf16
    tie the two may round it apart (`attention_bwd_bf16_slack`)."""
    return _attention_bwd(q, k, v, o, do, lse, causal, window, q_pos, group,
                          _round_bf16)


# How far the kernel's float32 sums of bf16 products (S, dP, D) and the
# plain version's may lie apart, relative to the sum of the terms'
# magnitudes: 16 units of float32 rounding (2^-24).  The tensor core
# truncates once per k16 step (hd / 16 <= 8 steps, at most a unit each);
# a float32 sum in another order differs by ~sqrt(hd) units.  On the CPU,
# float32 against float64 of the same arithmetic needs 2^-22 at S = 2048.
SUM_EPS = 2.0 ** -20


def _flip(x: torch.Tensor, dx: torch.Tensor) -> torch.Tensor:
    """How far bf16 rounding can move x's rounded value when x itself is
    known only to within dx: |bf16(x + dx) - bf16(x - dx)|, one bf16 unit
    where a tie lies within dx of x, else 0."""
    return (_round_bf16(x + dx) - _round_bf16(x - dx)).abs()


def attention_bwd_bf16_slack(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             do: torch.Tensor, lse: torch.Tensor, *,
                             causal: bool = True, window: int = 0,
                             q_pos: Optional[torch.Tensor] = None,
                             group: int = 1
                             ) -> tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """For each element of `attention_bwd_bf16_ref`'s (dq, dk, dv), the
    most it can move when P or dS rounds to the other bf16 neighbour: the
    kernel and the plain version compute P and dS in float32 sums of other
    orders, so where one lies within their difference of a bf16 tie, the
    two round it apart by one bf16 unit, which moves each gradient term it
    feeds by that unit times the other factor.  The difference is bounded
    by SUM_EPS times the sums' absolute terms: dP and D by SUM_EPS
    sum |dO v| and sum |dO o|, P by P SUM_EPS (scale sum |q k| + |L| + 1)
    (the exponent's argument and exp itself), and dS = P (dP - D) by
    P (d dP + d D) + |dP - D| d P.  Then slack_dv = sum_i flip(P) |dO|,
    slack_dq = scale sum_j flip(dS) |k|, slack_dk = scale sum_i flip(dS)
    |q|.  Zero for all but the few elements fed by a term at a tie."""
    qf, kf, vf, of, dof, scale, mask, p, dp, dl = _bwd_terms(
        q, k, v, o, do, lse, causal, window, q_pos, group)
    lf = lse.to(p.dtype)[..., None]
    e = SUM_EPS
    p_err = p * e * (torch.einsum("bqd,bkd->bqk", qf.abs(), kf.abs())
                     * scale + lf.abs() + 1)
    dpl_err = e * (torch.einsum("bqd,bkd->bqk", dof.abs(), vf.abs())
                   + torch.sum((dof * of).abs(), dim=-1, keepdim=True))
    ds_err = p * dpl_err + (dp - dl).abs() * p_err
    fp = torch.where(mask, _flip(p, p_err), 0.0)
    fs = torch.where(mask, _flip(p * (dp - dl), ds_err), 0.0)
    sv = torch.einsum("bqk,bqd->bkd", fp, dof.abs())
    sq = torch.einsum("bqk,bkd->bqd", fs, kf.abs()) * scale
    sk = torch.einsum("bqk,bqd->bkd", fs, qf.abs()) * scale
    return (sq, sk.unflatten(0, (-1, group)).sum(1),
            sv.unflatten(0, (-1, group)).sum(1))
