"""Mamba2 / SSD (state-space duality) layer [arXiv:2405.21060].

Counterpart of `repro/models/lm/ssm.py`: the chunked SSD forward (an
attention-like block within each chunk plus a recurrence over the chunks'
states), its O(1) decode step and the sequential oracle.  Single B/C group
(G = 1), multi-head over d_inner / P heads.

The reference's dtype flow is kept: the projections and the causal conv
run in the activation dtype; the gates, the decay math, the states and the
intra / inter-chunk sums in float32; in decode the conv runs in float32
(unlike prefill).  The intra-chunk einsum is taken in a fixed order so
that no intermediate is larger than one (B, nc, H, Q, Q) float32 tensor,
and the reference's `lax.scan` over chunks is a loop that emits the state
*before* each chunk.  One departure: the causal mask of the intra-chunk
decay is applied before its exp, not after, which leaves every value as
the reference's and keeps the gradient finite where the masked exponent
overflows (the reference's is NaN there).

Decode: h' = exp(dt*A) h + dt * (B ⊗ x);  y = C·h' + D_skip * x.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.lm.layers import _init, dense_init, rmsnorm


def ssm_init(gen, cfg, device=None, lead=()):
    """The reference's leaves (projections kept separate: z / x / BC / dt),
    `lead`-stacked.  `out_proj` is drawn from its own stream where the
    reference reuses `proj_dt`'s key; the port's draws are its own anyway
    (carry weights across with `repro_torch.interop` to compare)."""
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    k = cfg.ssm_conv

    def const(values):
        t = values.to(device=device).expand(*lead, h)
        return t.clone()

    return {
        "proj_z": dense_init(gen, d, (di,), device, lead),
        "proj_x": dense_init(gen, d, (di,), device, lead),
        "proj_bc": dense_init(gen, d, (2 * n,), device, lead),
        "proj_dt": dense_init(gen, d, (h,), device, lead),
        "conv_x": _init(gen, (*lead, k, di), (1.0 / k) ** 0.5, device),
        "conv_bc": _init(gen, (*lead, k, 2 * n), (1.0 / k) ** 0.5, device),
        "A_log": const(torch.log(torch.linspace(1.0, 16.0, h,
                                                dtype=torch.float32))),
        "D_skip": const(torch.ones((h,), dtype=torch.float32)),
        "dt_bias": const(torch.full((h,), math.log(math.expm1(0.01)),
                                    dtype=torch.float32)),
        "norm": {"scale": torch.ones((*lead, di), dtype=torch.float32,
                                     device=device)},
        "out_proj": dense_init(gen, di, (d,), device, lead),
    }


def _project(p, x):
    """x (..., D) -> (z, x_raw, bc_raw, dt_raw) pre-conv projections."""
    dt = x.dtype
    return (x @ p["proj_z"].to(dt), x @ p["proj_x"].to(dt),
            x @ p["proj_bc"].to(dt), x @ p["proj_dt"].to(dt))


def _causal_conv(u, conv_w):
    """Depthwise causal conv via shift-stack (window = ssm_conv), in u's
    dtype."""
    k, s_len = conv_w.shape[0], u.shape[1]
    pads = F.pad(u, (0, 0, k - 1, 0))
    out = pads[:, 0:s_len] * conv_w[0].to(u.dtype)
    for i in range(1, k):
        out = out + pads[:, i:i + s_len] * conv_w[i].to(u.dtype)
    return F.silu(out)


def _gates(p, dt_raw):
    """(dt = softplus(dt_raw + dt_bias), a = -exp(A_log)) in float32."""
    dt = F.softplus(dt_raw.to(torch.float32) + p["dt_bias"])
    return dt, -torch.exp(p["A_log"])


def ssm_forward(p, cfg, x, with_state=False):
    """x (B, S, D) -> (B, S, D).  S must be a multiple of ssm_chunk.  With
    `with_state`, (y, (state, conv_x, conv_bc)): the state after the last
    chunk and the last ssm_conv raw inputs of each conv, the decode cache
    that prefill leaves."""
    b, s_len, _ = x.shape
    di, n, h, pd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    q = min(cfg.ssm_chunk, s_len)
    assert s_len % q == 0, f"seq {s_len} not divisible by ssm chunk {q}"
    nc = s_len // q

    z, x_raw, bc_raw, dt_raw = _project(p, x)
    xc_in = _causal_conv(x_raw, p["conv_x"])
    bc = _causal_conv(bc_raw, p["conv_bc"])
    x_in = xc_in.reshape(b, s_len, h, pd).to(torch.float32)
    b_mat = bc[..., :n].to(torch.float32).reshape(b, nc, q, n)
    c_mat = bc[..., n:].to(torch.float32).reshape(b, nc, q, n)
    dt, a = _gates(p, dt_raw)                                 # (B,S,H), (H,)

    xc = x_in.reshape(b, nc, q, h, pd)
    dtc = dt.reshape(b, nc, q, h).transpose(2, 3)             # (B,nc,H,q)
    # within-chunk, along the innermost axis (CUDA's scan along an outer
    # axis is ~50x slower)
    cum = torch.cumsum((dtc * a[:, None]).contiguous(), dim=-1)

    # ---- intra-chunk: y[i] = sum_j C_i.B_j exp(cum_i - cum_j) dt_j x_j,
    # j <= i, as (scores * decay) @ (dt x), heads batched: the largest
    # tensor is one (B, nc, H, q, q) float32.  The mask goes inside the
    # exp: above the diagonal cum_i - cum_j > 0 can overflow, and the
    # reference's where(tri, exp(li), 0) then gives the same values but a
    # NaN gradient (0 * inf)
    scores = c_mat @ b_mat.transpose(-1, -2)                  # (B,nc,q,q)
    tri = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    decay = torch.exp(torch.where(tri, cum[..., :, None]
                                  - cum[..., None, :], -torch.inf))
    xc_h = xc.transpose(2, 3)                                 # (B,nc,H,q,P)
    y_intra = (decay * scores[:, :, None]) @ (dtc[..., None] * xc_h)

    # ---- inter-chunk recurrence over the chunks' states ------------------
    decay_to_end = torch.exp(cum[..., -1:] - cum)             # (B,nc,H,q)
    v = (decay_to_end * dtc)[..., None, :] * xc_h.transpose(-1, -2)
    states = v @ b_mat[:, :, None]                            # (B,nc,H,P,N)
    chunk_decay = torch.exp(cum[..., -1])                     # (B,nc,H)
    carry = torch.zeros((b, h, pd, n), dtype=torch.float32, device=x.device)
    prev = []
    for c in range(nc):                        # emit the state before chunk
        prev.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, 1)                        # (B,nc,H,P,N)
    y_inter = (prev_states @ c_mat[:, :, None].transpose(-1, -2)
               ).transpose(-1, -2) * cum.exp()[..., None]     # (B,nc,H,q,P)

    y = (y_intra + y_inter).transpose(2, 3).reshape(b, s_len, h, pd)
    y = y + p["D_skip"][:, None] * x_in
    y = y.reshape(b, s_len, di)

    # gated RMSNorm then output projection
    y = rmsnorm(p["norm"], y.to(x.dtype)) * F.silu(z)
    y = y @ p["out_proj"].to(x.dtype)
    if not with_state:
        return y
    k = cfg.ssm_conv
    return y, (carry, F.pad(x_raw, (0, 0, k - 1, 0))[:, -k:],
               F.pad(bc_raw, (0, 0, k - 1, 0))[:, -k:])


# ------------------------------------------------------------- decode ------
def ssm_cache_init(cfg, batch, dtype, device=None):
    di, n = cfg.d_inner, cfg.ssm_state
    return {
        "state": torch.zeros((batch, cfg.ssm_heads, cfg.ssm_head_dim, n),
                             dtype=torch.float32, device=device),
        "conv_x": torch.zeros((batch, cfg.ssm_conv, di), dtype=dtype,
                              device=device),
        "conv_bc": torch.zeros((batch, cfg.ssm_conv, 2 * n), dtype=dtype,
                               device=device),
    }


def ssm_decode_step(p, cfg, x, cache):
    """x (B, D) one token -> (y (B, D), new cache).  The cache passed in is
    not written; the model's `decode_step` copies the new one into its
    stacked cache."""
    di, n, h, pd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    z, x_new, bc_new, dt_raw = _project(p, x)

    conv_x = torch.cat([cache["conv_x"][:, 1:], x_new[:, None]], dim=1)
    conv_bc = torch.cat([cache["conv_bc"][:, 1:], bc_new[:, None]], dim=1)
    xc = F.silu((conv_x.to(torch.float32) * p["conv_x"]).sum(1))
    bc = F.silu((conv_bc.to(torch.float32) * p["conv_bc"]).sum(1))
    x_in = xc.reshape(-1, h, pd)
    b_mat, c_mat = bc[:, :n], bc[:, n:]
    dt, a = _gates(p, dt_raw)                                 # (B,H), (H,)

    da = torch.exp(dt * a)                                    # (B,H)
    state = (cache["state"] * da[:, :, None, None]
             + (dt[:, :, None] * x_in)[..., None] * b_mat[:, None, None, :])
    y = (state @ c_mat[:, None, :, None])[..., 0]             # (B,H,P)
    y = y + p["D_skip"][None, :, None] * x_in
    y = y.reshape(-1, di)

    y = rmsnorm(p["norm"], y.to(x.dtype)) * F.silu(z)
    y = y @ p["out_proj"].to(x.dtype)
    return y, {"state": state, "conv_x": conv_x, "conv_bc": conv_bc}


# --------------------------------------------------- reference (oracle) ----
def ssm_forward_ref(p, cfg, x):
    """Sequential O(S) recurrence: the oracle for the chunked path."""
    cache = ssm_cache_init(cfg, x.shape[0], x.dtype, x.device)
    ys = []
    for t in range(x.shape[1]):
        y, cache = ssm_decode_step(p, cfg, x[:, t], cache)
        ys.append(y)
    return torch.stack(ys, dim=1)
