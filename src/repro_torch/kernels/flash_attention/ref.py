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
