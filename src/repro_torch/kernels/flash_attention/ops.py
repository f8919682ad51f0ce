"""Public wrappers (counterpart of `repro/kernels/flash_attention/ops.py`).

`flash_attention(q, k, v)` keeps the reference kernel's (BH, S, hd)
contract; `flash_attention_gqa(q, k, v)` takes the model's (B, S, Hq, hd)
query and (B, T, Kh, hd) KV tensors, like the reference's
`flash_attention_tpu`.  A CUDA tensor goes to the CUDA kernel, which reads
KV head h // G for query head h in place and masks ragged S and T (the
reference's repeat of KV per group and its `S % block_q == 0` cut-over
exist only for the Pallas kernel's layout); a CPU tensor goes to the plain
version, `attention_ref`, with KV repeated per group as the reference does.
On the card both dtypes run on the tensor cores: bf16 with the softmax
probabilities rounded to bf16 before they multiply V, float32 as split-TF32
products with float32 probabilities (see `kernel.py`).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import use_kernel
from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.kernels.flash_attention.ref import attention_ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q (BH, S, hd); k/v (BH, T, hd) -> (BH, S, hd)."""
    if use_kernel(q):
        return flash_attention_cuda(q[:, :, None], k[:, :, None],
                                    v[:, :, None], causal=causal,
                                    window=window)[:, :, 0]
    return attention_ref(q, k, v, causal=causal, window=window)


def flash_attention_gqa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, q_pos: Optional[torch.Tensor] = None,
                        causal: bool = True, window: int = 0
                        ) -> torch.Tensor:
    """q (B, S, Hq, hd); k/v (B, T, Kh, hd) -> (B, S, Hq, hd).  Query
    positions `q_pos` (S,) default to 0 .. S-1; key positions are
    0 .. T-1."""
    if use_kernel(q):
        return flash_attention_cuda(q, k, v, q_pos, causal=causal,
                                    window=window)
    b, s_len, hq, hd = q.shape
    t_len, kh = k.shape[1], k.shape[2]
    g = hq // kh
    # (B, S, Kh, G, hd) -> (B*Kh*G, S, hd); KV repeated per group
    qf = q.reshape(b, s_len, kh, g, hd).permute(0, 2, 3, 1, 4)
    qf = qf.reshape(b * kh * g, s_len, hd)
    kf = torch.repeat_interleave(k.transpose(1, 2), g, dim=1).reshape(
        b * kh * g, t_len, hd)
    vf = torch.repeat_interleave(v.transpose(1, 2), g, dim=1).reshape(
        b * kh * g, t_len, hd)
    of = attention_ref(qf, kf, vf, causal=causal, window=window, q_pos=q_pos)
    o = of.reshape(b, kh, g, s_len, hd).permute(0, 3, 1, 2, 4)
    return o.reshape(b, s_len, hq, hd)
