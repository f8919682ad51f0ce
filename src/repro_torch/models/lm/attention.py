"""GQA attention: dense reference, chunked flash, decode against a cache.

Counterpart of `repro/models/lm/attention.py`.  Shapes: q (B, S, Hq, hd)
with Hq = Kh * G (GQA group G); k/v (B, T, Kh, hd).  q is regrouped to
(B, S, Kh, G, hd) so the contractions never repeat KV heads.

The flash branch routes by device.  A CUDA tensor (and a `meta` tensor,
which a dry run counts: the kernels' shapes, nothing computed) goes to the
hand-written
`flash_attention` kernel (`kernels/flash_attention`), which skips the key
tiles outside each query tile's causal / sliding-window band; under grad
it runs through `FlashAttentionFn`, whose backward is the hand-written
`flash_attention_bwd` kernel.  A CPU tensor goes to a plain online
softmax over `kv_chunk` blocks, the direct counterpart of the reference's
`lax.scan`, which skips fully masked blocks as the reference's `lax.cond`
does, and which autograd differentiates as JAX differentiates the scan.
(The reference's model never reaches its Pallas kernel; the port sends
this branch to its kernels on purpose.)
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import use_kernel
from repro_torch.kernels.flash_attention.ops import flash_attention_gqa

NEG_INF = -1e30


def _mask(q_pos, kv_pos, *, causal: bool, window: int, kv_valid=None):
    """(S, T) boolean mask: True = attend."""
    m = torch.ones(q_pos.shape + kv_pos.shape, dtype=torch.bool,
                   device=q_pos.device)
    if causal:
        m &= kv_pos[None, :] <= q_pos[:, None]
    if window > 0:
        m &= kv_pos[None, :] > q_pos[:, None] - window
    if kv_valid is not None:
        m &= kv_valid[None, :]
    return m


def dense_attention(q, k, v, *, q_pos, kv_pos, causal=True, window=0,
                    kv_valid=None):
    """Reference / decode path. q (B,S,Hq,hd), k/v (B,T,Kh,hd)."""
    b, s_len, hq, hd = q.shape
    kh = k.shape[2]
    g = hq // kh
    qg = q.reshape(b, s_len, kh, g, hd)
    scale = hd ** -0.5
    s = torch.einsum("bskgd,btkd->bkgst", qg.to(torch.float32),
                     k.to(torch.float32)) * scale
    mask = _mask(q_pos, kv_pos, causal=causal, window=window,
                 kv_valid=kv_valid)
    s = torch.where(mask[None, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgst,btkd->bskgd", p, v.to(torch.float32))
    return o.reshape(b, s_len, hq, hd).to(q.dtype)


def _flash_block(qg, kb, vb, mask, acc, m, l, scale):
    """One KV block's online-softmax update of (acc, m, l)."""
    s = torch.einsum("bskgd,btkd->bkgst", qg, kb) * scale
    s = torch.where(mask[None, None, None], s, NEG_INF)
    m_new = torch.maximum(m, torch.amax(s, dim=-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l_new = l * corr + torch.sum(p, dim=-1)
    acc_new = acc * corr[..., None] + torch.einsum("bkgst,btkd->bkgsd", p, vb)
    return acc_new, m_new, l_new


def _chunked_flash(q, k, v, *, q_pos, causal, window, kv_chunk, remat=False):
    """The plain online softmax over KV blocks (CPU route).  `remat`
    checkpoints each block's update, as the reference's `jax.checkpoint
    (body)` does: the backward recomputes it instead of keeping each
    block's (S, kv_chunk) probabilities."""
    b, s_len, hq, hd = q.shape
    t_len, kh = k.shape[1], k.shape[2]
    g = hq // kh
    qg = q.reshape(b, s_len, kh, g, hd).to(torch.float32)
    scale = hd ** -0.5
    acc = torch.zeros((b, kh, g, s_len, hd), dtype=torch.float32,
                      device=q.device)
    m = torch.full((b, kh, g, s_len), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, kh, g, s_len), dtype=torch.float32, device=q.device)
    for start in range(0, t_len - t_len % kv_chunk, kv_chunk):
        kv_pos = start + torch.arange(kv_chunk, device=q.device)
        mask = _mask(q_pos, kv_pos, causal=causal, window=window)
        if not bool(mask.any()):
            continue        # causal blocks in the future, SWA blocks behind
        kb = k[:, start:start + kv_chunk].to(torch.float32)
        vb = v[:, start:start + kv_chunk].to(torch.float32)
        args = (qg, kb, vb, mask, acc, m, l, scale)
        if remat and torch.is_grad_enabled():
            acc, m, l = checkpoint(_flash_block, *args, use_reentrant=False)
        else:
            acc, m, l = _flash_block(*args)
    o = acc / torch.clamp_min(l, 1e-30)[..., None]
    # (B,Kh,G,S,hd) -> (B,S,Hq,hd)
    o = torch.movedim(o, 3, 1).reshape(b, s_len, hq, hd)
    return o.to(q.dtype)


def flash_attention(q, k, v, *, q_pos, causal=True, window=0, kv_chunk=512,
                    remat=False):
    """Online softmax over KV blocks; memory O(S * kv_chunk) per head.

    Assumes T % kv_chunk == 0, as the reference does: keys past the last
    whole block are dropped on both routes, as the reference's scan drops
    them.  On a CUDA or meta tensor the kernels' route runs (their own 64-key tiles; the
    backward recomputes P from the forward's log-sum-exp, so `remat`, the
    reference's per-block checkpoint, changes nothing there); on a CPU
    tensor the plain blocked loop, with `remat` checkpointing each block.
    """
    if use_kernel(q):
        t_len = k.shape[1] - k.shape[1] % kv_chunk
        return flash_attention_gqa(q, k[:, :t_len], v[:, :t_len],
                                   q_pos=q_pos, causal=causal, window=window)
    return _chunked_flash(q, k, v, q_pos=q_pos, causal=causal, window=window,
                          kv_chunk=kv_chunk, remat=remat)


def attention(q, k, v, *, q_pos, kv_pos: Optional[torch.Tensor] = None,
              causal=True, window=0, impl="auto", kv_chunk=512,
              kv_valid=None, remat=False):
    """Dispatch: dense for short/decode, flash for long train/prefill."""
    t_len = k.shape[1]
    if impl == "auto":
        impl = ("flash" if (q.shape[1] > 1024 and t_len % kv_chunk == 0)
                else "dense")
    if impl == "flash":
        return flash_attention(q, k, v, q_pos=q_pos, causal=causal,
                               window=window, kv_chunk=kv_chunk, remat=remat)
    if kv_pos is None:
        kv_pos = torch.arange(t_len, device=q.device)
    return dense_attention(q, k, v, q_pos=q_pos, kv_pos=kv_pos, causal=causal,
                           window=window, kv_valid=kv_valid)
