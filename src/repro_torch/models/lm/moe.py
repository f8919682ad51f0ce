"""Mixture-of-Experts FFN with gather-based capacity dispatch.

Counterpart of `repro/models/lm/moe.py`.  Routing: softmax router, top-k
experts per token, per-expert capacity C (the reference's `_capacity`);
assignments past an expert's capacity are dropped (Switch / GShard).  An
(E, C) token-index table is built from each assignment's token-major rank
within its expert, and the experts' inputs are gathered through it.

Where the port departs from a literal translation, and why:

- top-k is a stable descending sort, so tied probabilities keep the lower
  expert index first, as `jax.lax.top_k` does (`torch.topk` promises no
  order among ties, and bf16 router logits tie often);
- the combine gathers each token's top_k kept contributions by (token, k)
  and sums them in that order, where the reference scatter-adds the
  (E, C) contributions into the tokens: CUDA's float `index_add_` uses
  atomics, so its sums would change from run to run;
- the reference's `constrain` hook is left out: the port places every
  tensor explicitly (below).

Tokens are processed in `n_groups` independent groups (the reference's
data-shard groups), each with its own tables and capacity.

Under a mesh (`models/lm/tp.py`): the experts are split over "model" when
E % model == 0 (each rank runs its block of them, the (token, k) combine
summed on each rank over its own experts, then all-reduced over
"model"); FSDP's data dims of w_gate / w_up / w_down are all-gathered at
use; the router stays replicated, so every rank builds the same tables.
A rank's rows are whole groups when the groups divide over the batch
shards (`launch_cfg` sets n_groups to the data shards); otherwise the
tokens are gathered over the batch axes, routed as one, and the rank
keeps its rows.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.launch import collectives as C
from repro_torch.models.lm import tp
from repro_torch.models.lm.layers import _init, dense_init


def moe_init(gen, cfg, device=None, lead=()):
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    p = {"router": dense_init(gen, d, (e,), device, lead),
         "w_up": _init(gen, (*lead, e, d, f), (1.0 / d) ** 0.5, device),
         "w_down": _init(gen, (*lead, e, f, d), (1.0 / f) ** 0.5, device)}
    if cfg.ffn_kind == "swiglu":
        p["w_gate"] = _init(gen, (*lead, e, d, f), (1.0 / d) ** 0.5, device)
    return p


def _capacity(cfg, tokens_per_group: int) -> int:
    c = int(tokens_per_group * cfg.top_k * cfg.capacity_factor
            / cfg.n_experts)
    return max(4, (c + 3) // 4 * 4)


def _top_k(probs, k):
    """(values, indices) of the k largest along the last axis, ties to the
    lower index (`jax.lax.top_k`'s order)."""
    w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return w[..., :k], idx[..., :k]


def _router(p, cfg, xt):
    """xt (..., D) -> probs (..., E) f32 and the renormalised top-k
    (weights, experts)."""
    logits = (xt @ p["router"].to(xt.dtype)).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    top_w, top_idx = _top_k(probs, cfg.top_k)
    top_w = top_w / torch.clamp_min(top_w.sum(-1, keepdim=True), 1e-9)
    return probs, top_w, top_idx


def moe_route(p, cfg, xg):
    """Routing of grouped tokens xg (G, Tg, D): the (G, E, C) tables
    `table` (token ids, int32), `valid` (f32 0/1) and `wtab` (f32 weights),
    each assignment's (G, Tg * top_k) expert and slot (the overflow column
    C for a dropped one), and the (G,) GShard aux loss."""
    g, tg, _ = xg.shape
    e, k = cfg.n_experts, cfg.top_k
    cap = _capacity(cfg, tg)
    probs, top_w, top_idx = _router(p, cfg, xg)               # (G,Tg,E/k)

    # rank of each assignment within its expert, token-major priority:
    # the reference's cumsum of the (Tg*k, E) one-hot, as a stable sort by
    # expert (the same integers; CUDA scans that one-hot along its long
    # outer axis ~100x slower)
    n = tg * k
    flat_e = top_idx.reshape(g, n)
    order = torch.argsort(flat_e, dim=1, stable=True)
    by_e = torch.gather(flat_e, 1, order)
    counts = torch.zeros((g, e), dtype=torch.int64, device=xg.device)
    counts.scatter_add_(1, flat_e, torch.ones_like(flat_e))
    first = torch.gather(counts.cumsum(1) - counts, 1, by_e)
    rank = torch.empty_like(order).scatter_(
        1, order, torch.arange(n, device=xg.device).expand(g, n) - first)
    slot = torch.where(rank < cap, rank, cap)

    # (E, C+1) tables; the +1 column swallows the dropped assignments,
    # every other (expert, slot) is written once
    gi = torch.arange(g, device=xg.device)[:, None].expand(g, tg * k)
    token_ids = torch.arange(tg, dtype=torch.int32,
                             device=xg.device).repeat_interleave(k)
    idx = (gi, flat_e, slot)
    table = torch.zeros((g, e, cap + 1), dtype=torch.int32, device=xg.device)
    table.index_put_(idx, token_ids.expand(g, -1))
    valid = torch.zeros((g, e, cap + 1), dtype=torch.float32,
                        device=xg.device)
    valid.index_put_(idx, torch.ones((), device=xg.device))
    wtab = torch.zeros((g, e, cap + 1), dtype=torch.float32,
                       device=xg.device)
    wtab.index_put_(idx, top_w.reshape(g, tg * k))

    # GShard load-balance aux: mean fraction * mean prob per expert (the
    # one-hot's mean is count / (Tg k) exactly)
    aux = e * torch.sum(counts.to(torch.float32) / n * probs.mean(1), dim=-1)
    return (table[..., :cap], valid[..., :cap], wtab[..., :cap], flat_e,
            slot, aux)


def _grouping(x, n_groups: int):
    """(x, the groups it holds, whether it was gathered): this rank's rows
    hold n_groups / shards whole groups when the groups divide over the
    rows' batch shards; else every rank's rows, all-gathered."""
    lay = tp.layout()
    shards = lay.mesh.size(lay.batch) if lay is not None else 1
    if shards == 1:
        return x, n_groups, False
    if n_groups % shards == 0:
        return x, n_groups // shards, False
    return C.gather(x, lay.batch, 0, "reduce_scatter", lay.mesh), n_groups, \
        True


def moe_apply(p, cfg, x, *, n_groups: int = 1):
    """x (B, S, D) -> ((B, S, D), aux load-balance loss)."""
    x, n_groups, gathered = _grouping(x, n_groups)
    b, s_len, d = x.shape
    t = b * s_len
    assert t % n_groups == 0, (t, n_groups)
    tg = t // n_groups
    xg = x.reshape(n_groups, tg, d)
    table, valid, wtab, flat_e, slot, aux = moe_route(p, cfg, xg)
    g, e, cap = table.shape

    dt = x.dtype
    w_up = tp.full(p["w_up"], "moe/w_up")
    w_down = tp.full(p["w_down"], "moe/w_down")
    e_l = w_up.shape[0]
    e0 = 0
    split = tp.split("moe/w_up", 0)
    if split:
        # this rank's experts: their inputs and weights are its own, the
        # replicated tables' weights too (summed back by the backward)
        e0 = tp.model_index() * e_l
        xg, wtab = tp.enter(xg), tp.enter(wtab)
        table, valid, wtab = (t_[:, e0:e0 + e_l] for t_ in (table, valid,
                                                            wtab))

    # gather each expert's inputs, (G, E, C, D), then run the experts on
    # the (E, G*C, D) rows
    gi = torch.arange(g, device=x.device)[:, None]
    rows = xg[gi[..., None], table.to(torch.int64)]             # (G,E,C,D)
    expert_in = (rows * valid[..., None].to(x.dtype)).transpose(0, 1)
    expert_in = expert_in.reshape(e_l, g * cap, d)
    if cfg.ffn_kind == "swiglu":
        w_gate = tp.full(p["w_gate"], "moe/w_gate")
        h = F.silu(torch.bmm(expert_in, w_gate.to(dt)))
        h = h * torch.bmm(expert_in, w_up.to(dt))
    else:
        h = F.gelu(torch.bmm(expert_in, w_up.to(dt)), approximate="tanh")
    out = torch.bmm(h, w_down.to(dt)).reshape(e_l, g, cap, d)
    contrib = out.transpose(0, 1) * (wtab * valid)[..., None].to(dt)

    # combine: each token's top_k assignments, gathered by (token, k) and
    # summed in k order; a dropped one (slot C), or one to another rank's
    # expert, reads a zero row
    contrib = F.pad(contrib, (0, 0, 0, 1))                   # (G,E,C+1,D)
    if split:
        local = flat_e - e0
        mine = (local >= 0) & (local < e_l)
        flat_e = torch.where(mine, local, 0)
        slot = torch.where(mine, slot, cap)
    y = contrib[gi, flat_e, slot].reshape(g, tg, cfg.top_k, d).sum(2)
    if split:
        y = tp.leave(y)
    y = y.reshape(b, s_len, d)
    if gathered:
        lay = tp.layout()
        y = C.block(y, lay.batch, 0, lay.mesh)
    return y, aux.mean()


def moe_apply_ref(p, cfg, x):
    """Oracle: every expert on every token, no capacity (top-k weighting)."""
    b, s_len, d = x.shape
    xt = x.reshape(-1, d)
    probs, top_w, top_idx = _router(p, cfg, xt)
    gate = torch.zeros_like(probs).scatter(1, top_idx, top_w)   # (T, E)
    dt = xt.dtype
    if cfg.ffn_kind == "swiglu":
        h = F.silu(torch.einsum("td,edf->tef", xt, p["w_gate"].to(dt)))
        h = h * torch.einsum("td,edf->tef", xt, p["w_up"].to(dt))
    else:
        h = F.gelu(torch.einsum("td,edf->tef", xt, p["w_up"].to(dt)),
                   approximate="tanh")
    out = torch.einsum("tef,efd->ted", h, p["w_down"].to(dt))
    y = torch.einsum("ted,te->td", out, gate.to(dt))
    return y.reshape(b, s_len, d)
