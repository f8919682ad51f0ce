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

Training: when grad is enabled and q, k or v requires it,
`flash_attention_gqa` runs `FlashAttentionFn`, whose forward also keeps
each row's log-sum-exp and whose backward recomputes P from it: on a CUDA
tensor the forward kernel (with its lse output) and the backward kernel
(`flash_attention_bwd_cuda`, on the tensor cores in both dtypes: bf16
with P and dS rounded to bf16, float32 as split-TF32 products with
float32 P and dS), on a CPU tensor `attention_ref` and
`attention_bwd_ref`.  Otherwise the forward call above runs unchanged.

A meta tensor takes the kernels' route (`kernel.py`: empty outputs, the
lse included, nothing launched).  Each call runs under `kernels.counted`
with the kernel's shapes, whatever its route; the count takes the query
positions 0 .. S-1 (the model's; `q_pos` lives on the device and is not
read back).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import counted, use_kernel
from repro_torch.kernels.flash_attention.kernel import (
    flash_attention_bwd_cuda, flash_attention_cuda, wide,
)
from repro_torch.kernels.flash_attention.ref import (
    attention_bwd_ref, attention_ref,
)


def _name(q, backward=False) -> str:
    """The kernel a call on `q` runs, as `LAUNCHES` and the counts name
    it: the wide route past 128 head dims."""
    return ("flash_attention" + ("_wide" if wide(q.shape[-1]) else "")
            + ("_bwd" if backward else ""))


def _cost(q, k, causal, window, **extra) -> dict:
    """`kernels.counted`'s shapes of a call on (B, S, Hq, hd) q and
    (B, T, Kh, hd) k, or (BH, S, hd) q and k."""
    if q.dim() == 3:
        (b, s_len, hd), hq, kh = q.shape, 1, 1
    else:
        (b, s_len, hq, hd), kh = q.shape, k.shape[2]
    return dict(b=b, s=s_len, t=k.shape[1], hq=hq, kh=kh, hd=hd,
                itemsize=q.element_size(), causal=causal, window=window,
                **extra)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q (BH, S, hd); k/v (BH, T, hd) -> (BH, S, hd)."""
    with counted(_name(q), **_cost(q, k, causal, window)):
        if use_kernel(q):
            return flash_attention_cuda(q[:, :, None], k[:, :, None],
                                        v[:, :, None], causal=causal,
                                        window=window)[:, :, 0]
        return attention_ref(q, k, v, causal=causal, window=window)


def _heads(x: torch.Tensor) -> torch.Tensor:
    """(B, L, H, hd) -> (B*H, L, hd)."""
    return x.transpose(1, 2).flatten(0, 1)


def _unheads(x: torch.Tensor, b: int) -> torch.Tensor:
    """(B*H, L, hd) -> (B, L, H, hd)."""
    return x.unflatten(0, (b, -1)).transpose(1, 2)


def _forward_ref(q, k, v, q_pos, causal, window, with_lse=False):
    """The plain forward on (B, S, Hq, hd) / (B, T, Kh, hd), KV repeated
    per group as the reference does; (o, lse (B, Hq, S)) with `with_lse`.
    Contiguous, as the kernel writes them (so what follows runs the same
    ops on either route)."""
    g = q.shape[2] // k.shape[2]
    out = attention_ref(_heads(q), torch.repeat_interleave(_heads(k), g, 0),
                        torch.repeat_interleave(_heads(v), g, 0),
                        causal=causal, window=window, q_pos=q_pos,
                        with_lse=with_lse)
    if not with_lse:
        return _unheads(out, q.shape[0]).contiguous()
    o, lse = out
    return (_unheads(o, q.shape[0]).contiguous(),
            lse.unflatten(0, (q.shape[0], -1)).contiguous())


def attention_bwd_gqa_ref(q, k, v, o, do, lse, *, q_pos=None, causal=True,
                          window=0, plain=attention_bwd_ref):
    """`attention_bwd_ref` on the model's layout: q, o, do (B, S, Hq, hd),
    k, v (B, T, Kh, hd), lse (B, Hq, S) -> (dq, dk, dv) in that layout;
    `plain` takes another function of its arguments instead
    (`attention_bwd_bf16_ref`, the bf16 kernel's arithmetic,
    `attention_bwd_bf16_slack`, or `attention_bwd_split_tf32`, the
    float32 kernel's)."""
    b = q.shape[0]
    dq, dk, dv = plain(
        _heads(q), _heads(k), _heads(v), _heads(o), _heads(do),
        lse.flatten(0, 1), causal=causal, window=window, q_pos=q_pos,
        group=q.shape[2] // k.shape[2])
    return _unheads(dq, b), _unheads(dk, b), _unheads(dv, b)


class FlashAttentionFn(torch.autograd.Function):
    """Differentiable flash attention on (B, S, Hq, hd) / (B, T, Kh, hd).
    The forward saves q, k, v, o and the per-row lse; the backward
    recomputes P = exp(scale QK^T - lse) from them (no (S, T) tensor is
    kept).  Routes by device like every wrapper: CUDA tensors to the two
    kernels, CPU tensors to the plain versions; there is no fallback."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, causal, window):
        with counted(_name(q), **_cost(q, k, causal, window, lse=True)):
            if use_kernel(q):
                o, lse = flash_attention_cuda(q, k, v, q_pos, causal=causal,
                                              window=window, with_lse=True)
            else:
                o, lse = _forward_ref(q, k, v, q_pos, causal, window,
                                      with_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.q_pos, ctx.causal, ctx.window = q_pos, causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        fn = (flash_attention_bwd_cuda if use_kernel(q)
              else attention_bwd_gqa_ref)
        with counted(_name(q, backward=True),
                     **_cost(q, k, ctx.causal, ctx.window)):
            # contiguous on both routes, as the kernel writes them
            dq, dk, dv = (g.contiguous() for g in fn(
                q, k, v, o, do, lse, q_pos=ctx.q_pos, causal=ctx.causal,
                window=ctx.window))
        return dq, dk, dv, None, None, None


def flash_attention_gqa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, q_pos: Optional[torch.Tensor] = None,
                        causal: bool = True, window: int = 0
                        ) -> torch.Tensor:
    """q (B, S, Hq, hd); k/v (B, T, Kh, hd) -> (B, S, Hq, hd).  Query
    positions `q_pos` (S,) default to 0 .. S-1; key positions are
    0 .. T-1.  Differentiable (through `FlashAttentionFn`) when grad is
    enabled and an input requires it.  Any head dim: past 128 the wide
    route runs (`kernel.py::route`: up to 256 on the tensor cores, wider
    on the CUDA cores)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, q_pos, causal, window)
    with counted(_name(q), **_cost(q, k, causal, window)):
        if use_kernel(q):
            return flash_attention_cuda(q, k, v, q_pos, causal=causal,
                                        window=window)
        return _forward_ref(q, k, v, q_pos, causal, window)
