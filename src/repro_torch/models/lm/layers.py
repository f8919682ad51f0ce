"""Shared layer primitives: norms, RoPE, FFN, embeddings.

Counterpart of `repro/models/lm/layers.py`.  Pure functions over param
dicts with the reference's keys and shapes; initialisers take an explicit
`torch.Generator` and draw on its device.  The reference's casts are kept:
weights are cast to the activation dtype before each product, norms and
RoPE compute in float32 and round once to the activation dtype, and the
LM head's logits are upcast to float32 after its product.

Under a mesh (`models/lm/tp.py`) the FFN is column-parallel in `w_gate` /
`w_up` and row-parallel in `w_down`, followed by an all-reduce over
"model"; the embedding table is sharded on D (the local columns gathered,
then all-gathered on D); the head is vocab-parallel; FSDP's "data" dims
are all-gathered at use.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.lm import tp


def _init(gen: torch.Generator, shape, scale: float,
          device=None) -> torch.Tensor:
    """Float32 normals times `scale`, drawn on `gen`'s device, then moved to
    `device` (drawn in place, so a large leaf costs one buffer).  On
    `meta` nothing is drawn: the leaf's shape and dtype only."""
    if device is not None and torch.device(device).type == "meta":
        return torch.empty(shape, dtype=torch.float32, device="meta")
    x = torch.empty(shape, dtype=torch.float32, device=gen.device)
    x.normal_(generator=gen).mul_(scale)
    return x if device is None else x.to(device)


def dense_init(gen, d_in, shape_out, device=None, lead=()):
    """Weight (*lead, d_in, *shape_out) with fan-in scaling; `lead` stacks
    layers on a leading axis."""
    return _init(gen, (*lead, d_in, *shape_out), (1.0 / d_in) ** 0.5, device)


# ---------------------------------------------------------------- norms ----
def norm_init(d, device=None, lead=()):
    return {"scale": torch.ones((*lead, d), dtype=torch.float32,
                                device=device)}


def rmsnorm(p, x, eps=1e-6):
    xf = x.to(torch.float32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"]).to(x.dtype)


def layernorm(p, x, eps=1e-6):
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"]).to(x.dtype)


def apply_norm(kind, p, x):
    return rmsnorm(p, x) if kind == "rms" else layernorm(p, x)


# ----------------------------------------------------------------- RoPE ----
def rope_frequencies(hd: int, frac: float, theta: float,
                     device=None) -> torch.Tensor:
    """Inverse frequencies for the rotary fraction of the head dim."""
    rot = int(hd * frac) // 2 * 2
    expo = torch.arange(0, rot, 2, dtype=torch.float32, device=device) / rot
    return 1.0 / (theta ** expo)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *, frac: float,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: (S,) absolute token positions.

    Rotates the first `frac * hd` components (chatglm3 2D-RoPE == frac 0.5)
    as interleaved (even, odd) pairs, passes the rest through unchanged.
    """
    hd = x.shape[-1]
    inv = rope_frequencies(hd, frac, theta, device=x.device)
    rot = inv.shape[0] * 2
    ang = positions[:, None].to(torch.float32) * inv[None, :]   # (S, rot/2)
    shape = (1,) * (x.dim() - 3) + (positions.shape[0], 1, inv.shape[0])
    cos = torch.cos(ang).reshape(shape)
    sin = torch.sin(ang).reshape(shape)
    xr = x[..., :rot].to(torch.float32)
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x1 * sin + x2 * cos
    yr = torch.stack([y1, y2], dim=-1).reshape(xr.shape).to(x.dtype)
    return torch.cat([yr, x[..., rot:]], dim=-1)


# ------------------------------------------------------------------ FFN ----
def ffn_init(gen, d_model, d_ff, kind, device=None, lead=()):
    if kind == "swiglu":
        return {"w_gate": dense_init(gen, d_model, (d_ff,), device, lead),
                "w_up": dense_init(gen, d_model, (d_ff,), device, lead),
                "w_down": dense_init(gen, d_ff, (d_model,), device, lead)}
    return {"w_up": dense_init(gen, d_model, (d_ff,), device, lead),
            "w_down": dense_init(gen, d_ff, (d_model,), device, lead)}


def ffn_apply(p, x, kind):
    """The FFN; column-parallel in w_gate / w_up and row-parallel in w_down
    where the mesh's rules split d_ff."""
    dt = x.dtype
    w_up = tp.full(p["w_up"], "ffn/w_up")
    w_down = tp.full(p["w_down"], "ffn/w_down")
    split = tp.split("ffn/w_up", 1)
    if split:
        x = tp.enter(x)
    if kind == "swiglu":
        w_gate = tp.full(p["w_gate"], "ffn/w_gate")
        h = F.silu(x @ w_gate.to(dt)) * (x @ w_up.to(dt))
    else:
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(x @ w_up.to(dt), approximate="tanh")
    y = h @ w_down.to(dt)
    return tp.leave(y) if split else y


# ----------------------------------------------------------- embeddings ----
def embed_init(gen, vocab, d_model, device=None):
    return {"table": _init(gen, (vocab, d_model), 0.02, device)}


def embed_apply(p, tokens, dtype):
    """Rows of the table in `dtype` (gathered, then cast: the same values as
    the reference's cast-then-gather, without casting the whole table); a
    table sharded on D gathers its columns, then all-gathers them on D."""
    x = p["table"][tokens].to(dtype)
    if tp.split("embed/table", 1):
        x = tp.gather_model(x, -1)
    return x


def head_init(gen, d_model, vocab, device=None):
    return {"w": dense_init(gen, d_model, (vocab,), device)}


def head_apply(p, x):
    """LM head: (B, S, D) @ (D, V) in the activation dtype -> logits
    upcast to float32; vocab-parallel (this rank's block of V) where the
    mesh's rules split V."""
    w = tp.full(p["w"], "head/w")
    if tp.split("head/w", 1):
        x = tp.enter(x)
    return (x @ w.to(x.dtype)).to(torch.float32)


def cross_entropy_tokens(logits: torch.Tensor, labels: torch.Tensor,
                         mask: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Mean CE over (B, S) tokens; logits (B, S, V) float32."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.to(torch.int64)[..., None])[..., 0]
    per = logz - gold
    if mask is None:
        return torch.mean(per)
    m = mask.to(torch.float32)
    return torch.sum(per * m) / torch.clamp_min(torch.sum(m), 1.0)
