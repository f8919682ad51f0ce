"""Dense decoder-only LM: init, forward, loss, train step, prefill and
ring-cache decode.

Counterpart of `repro/models/lm/model.py` for the dense family (llama /
mistral-style: H2O-Danube-3, TinyLlama, ChatGLM3, Mistral-NeMo).  Params
are nested dicts of tensors with the reference's keys and shapes; layer
params stay stacked on a leading L axis, as `init_params` makes them, and
the layer loop is a Python loop over views of that axis.

Public API:
    init_params(cfg, gen, device=None)        -> params
    forward(cfg, params, batch)               -> (logits (B, S, V) f32, aux)
    loss_fn(cfg, params, batch)               -> scalar
    loss_and_grads(cfg, params, batch)        -> (loss, grads)
    make_train_step(cfg)                      -> (opt_init, train_step)
    train_step(cfg, params, opt_state, batch) -> (params', opt', {"loss"})
    init_cache(cfg, batch, seq_len, device)   -> cache
    prefill_step(cfg, params, batch, cache_len=None) -> (cache, last_logits)
    decode_step(cfg, params, cache, batch)    -> (cache, logits (B, V))

Training is functional like the reference's: `train_step` takes the
gradients of `loss_fn` with `torch.autograd.grad` over the param leaves
(stacked layer leaves included) and returns new params and optimizer
state.  `cfg.remat` checkpoints each decoder layer (the reference's
`jax.checkpoint` of the layer body), and on the card the flash branch runs
the `flash_attention` forward and backward kernels.  `forward` builds an
autograd graph only when grad is enabled and a param requires it;
`prefill_step` and `decode_step` always serve under `no_grad`.

Decode caches: k/v are (L, B, C, Kh, hd) ring buffers (C = window for SWA
archs, O(window) memory) and `pos` is the next position, a Python int (so
decode needs no host sync).  `decode_step` writes the new token's k/v into
the cache's tensors in place, where the reference returns new arrays: the
cache passed in is consumed.

MoE, SSM, hybrid, encoder-decoder and frontend families raise
`NotImplementedError` (ROADMAP queue 1, item 7b).
"""
from __future__ import annotations

from typing import Any, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models.lm.attention import attention, dense_attention
from repro_torch.models.lm.config import ArchConfig
from repro_torch.models.lm.layers import (
    apply_norm, apply_rope, cross_entropy_tokens, dense_init, embed_apply,
    embed_init, ffn_apply, ffn_init, head_apply, head_init, norm_init,
)
from repro_torch.optim import make_optimizer
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

Params = Any

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def check_served(cfg: ArchConfig) -> None:
    """Raise for the families this port does not serve yet."""
    other = [what for what, yes in (
        ("MoE FFN", cfg.is_moe), ("SSM mixer", cfg.has_ssm),
        ("hybrid family", cfg.family == "hybrid"),
        ("encoder-decoder", bool(cfg.encoder_layers)),
        (f"{cfg.frontend} frontend", cfg.frontend != "none"),
        ("attention-free mixer", not cfg.has_attn)) if yes]
    if other:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(other)} is not ported yet; the port "
            f"serves and trains dense decoder-only LMs (the other families "
            f"are ROADMAP queue 1, item 7b)")


# ======================================================== attention =========
def attn_init(gen, cfg: ArchConfig, device=None, lead=()):
    d, hq, kh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    wo = torch.empty((*lead, hq, hd, d), dtype=torch.float32,
                     device=gen.device)
    wo.normal_(generator=gen).mul_((1.0 / (hq * hd)) ** 0.5)
    return {
        "wq": dense_init(gen, d, (hq, hd), device, lead),
        "wk": dense_init(gen, d, (kh, hd), device, lead),
        "wv": dense_init(gen, d, (kh, hd), device, lead),
        "wo": wo if device is None else wo.to(device),
    }


def _proj(x, w):
    """einsum("bsd,dhe->bshe", x, w) as one matmul in x's dtype."""
    d, h, e = w.shape
    return (x @ w.to(x.dtype).reshape(d, h * e)).unflatten(-1, (h, e))


def _out(o, w):
    """einsum("bshe,hed->bsd", o, w) as one matmul in o's dtype."""
    h, e, d = w.shape
    return o.flatten(-2) @ w.to(o.dtype).reshape(h * e, d)


def _qkv(p, cfg, x, *, q_pos, kv_pos):
    q = _proj(x, p["wq"])
    k = _proj(x, p["wk"])
    v = _proj(x, p["wv"])
    q = apply_rope(q, q_pos, frac=cfg.rope_frac, theta=cfg.rope_theta)
    k = apply_rope(k, kv_pos, frac=cfg.rope_frac, theta=cfg.rope_theta)
    return q, k, v


def attn_apply_seq(p, cfg: ArchConfig, x, *, return_kv=False):
    """Full-sequence causal self-attention (forward / prefill)."""
    pos = torch.arange(x.shape[1], device=x.device)
    q, k, v = _qkv(p, cfg, x, q_pos=pos, kv_pos=pos)
    o = attention(q, k, v, q_pos=pos, kv_pos=pos, causal=True,
                  window=cfg.window, impl=cfg.attn_impl,
                  kv_chunk=cfg.attn_chunk, remat=cfg.attn_remat)
    y = _out(o, p["wo"])
    return (y, (k, v)) if return_kv else y


def _ring_positions(pos: int, cache_len: int, device=None) -> torch.Tensor:
    """Absolute position stored in each ring slot; negative => unwritten."""
    s = torch.arange(cache_len, device=device)
    return pos - torch.remainder(pos - s, cache_len)


def attn_apply_decode(p, cfg: ArchConfig, x, kv_cache, pos: int):
    """One-token decode. x (B, 1, D); kv_cache {k,v}: (B, C, Kh, hd), written
    in place at slot pos % C."""
    cache_len = kv_cache["k"].shape[1]
    # a fill on the device: torch.tensor([pos]) would copy from pageable
    # host memory, which waits for the card's queue at every layer
    q_pos = torch.full((1,), pos, dtype=torch.int64, device=x.device)
    q, k_new, v_new = _qkv(p, cfg, x, q_pos=q_pos, kv_pos=q_pos)
    slot = pos % cache_len
    kv_cache["k"][:, slot] = k_new[:, 0].to(kv_cache["k"].dtype)
    kv_cache["v"][:, slot] = v_new[:, 0].to(kv_cache["v"].dtype)
    kv_pos = _ring_positions(pos, cache_len, x.device)
    o = dense_attention(q, kv_cache["k"], kv_cache["v"], q_pos=q_pos,
                        kv_pos=kv_pos, causal=True, window=cfg.window,
                        kv_valid=kv_pos >= 0)
    return _out(o, p["wo"])


# ====================================================== layer blocks ========
def layer_init(gen, cfg: ArchConfig, device=None, lead=()):
    """One layer's params, or `lead`-stacked layers' (the reference vmaps
    `layer_init` over the layer keys; here each leaf is drawn stacked)."""
    check_served(cfg)
    p = {"norm1": norm_init(cfg.d_model, device, lead),
         "attn": attn_init(gen, cfg, device, lead)}
    if cfg.d_ff > 0:
        p["norm2"] = norm_init(cfg.d_model, device, lead)
        p["ffn"] = ffn_init(gen, cfg.d_model, cfg.d_ff, cfg.ffn_kind, device,
                            lead)
    return p


def _mix_sublayer(p, cfg: ArchConfig, x):
    """Token-mixing sublayer on the *normed* input (full-sequence path)."""
    return attn_apply_seq(p["attn"], cfg, apply_norm(cfg.norm_kind,
                                                     p["norm1"], x))


def _ffn_sublayer(p, cfg: ArchConfig, x):
    if cfg.d_ff > 0:
        h = apply_norm(cfg.norm_kind, p["norm2"], x)
        return ffn_apply(p["ffn"], h, cfg.ffn_kind)
    return torch.zeros_like(x)


def decoder_layer(p, cfg: ArchConfig, x):
    x = x + _mix_sublayer(p, cfg, x)
    return x + _ffn_sublayer(p, cfg, x)


def _layers(params: Params) -> list:
    """Every layer's params as views of the stacked leaves, by one unbind a
    leaf: its backward stacks the layers' gradients in one copy, where a
    select a layer would add an (L, ...) buffer of zeros a layer."""
    cols = tree_map(lambda t: t.unbind(0), params["layers"])
    n = tree_leaves(params["layers"])[0].shape[0]
    return [tree_map(lambda c: c[i], cols) for i in range(n)]


# ===================================================== init / forward =======
def init_params(cfg: ArchConfig, gen: torch.Generator,
                device=None) -> Params:
    """Random params in the reference's tree, drawn from `gen` on its own
    device and stored on `device` (default: the CUDA card).  A generator
    on the card draws a full-width model in well under a second; a CPU
    generator takes tens of seconds for billions of normals.  The numbers
    differ from the reference's threefry draws: carry weights across with
    `repro_torch.interop` to compare the two."""
    check_served(cfg)
    device = resolve_device(device)
    params = {
        "embed": embed_init(gen, cfg.vocab, cfg.d_model, device),
        "layers": layer_init(gen, cfg, device, lead=(cfg.n_layers,)),
        "final_norm": norm_init(cfg.d_model, device),
        "head": head_init(gen, cfg.d_model, cfg.vocab, device),
    }
    pdt = _DTYPES[cfg.param_dtype]
    if pdt != torch.float32:
        params = tree_map(lambda x: x.to(pdt), params)
    return params


def forward(cfg: ArchConfig, params: Params,
            batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward. Returns (logits (B,S,V) f32, aux loss 0).
    Under grad, `cfg.remat` recomputes each layer in the backward pass."""
    check_served(cfg)
    x = embed_apply(params["embed"], batch["tokens"], _dtype(cfg))
    remat = cfg.remat and torch.is_grad_enabled()
    for lp in _layers(params):
        if remat:
            # the layer draws nothing, so no RNG state needs keeping
            x = checkpoint(decoder_layer, lp, cfg, x, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = decoder_layer(lp, cfg, x)
    x = apply_norm(cfg.norm_kind, params["final_norm"], x)
    logits = head_apply(params["head"], x)
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


def loss_fn(cfg: ArchConfig, params: Params, batch: dict) -> torch.Tensor:
    """Mean next-token cross entropy over every position.  The reference's
    vision mask and MoE aux term belong to families that `check_served`
    refuses (ROADMAP queue 1, item 7b) and come with them."""
    logits, _ = forward(cfg, params, batch)
    labels = batch["tokens"][:, 1:]
    mask = torch.ones(labels.shape, dtype=torch.bool, device=labels.device)
    return cross_entropy_tokens(logits[:, :-1], labels, mask)


def loss_and_grads(cfg: ArchConfig, params: Params,
                   batch: dict) -> tuple[torch.Tensor, Params]:
    """`loss_fn` and its gradient tree (the reference's
    `jax.value_and_grad`), by `torch.autograd.grad` over the param leaves;
    `params` themselves are not touched."""
    leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
    with torch.enable_grad():
        loss = loss_fn(cfg, tree_unflatten(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), tree_unflatten(params, list(grads))


def make_train_step(cfg: ArchConfig):
    """(opt_init, train_step) with the reference's optimizer settings:
    SGD at lr 0.01, momentum 0.5, or AdamW at lr 3e-4."""
    opt_init, opt_step = make_optimizer(
        cfg.optimizer, lr=0.01 if cfg.optimizer == "sgd" else 3e-4,
        momentum=0.5)

    def train_step(params, opt_state, batch):
        loss, grads = loss_and_grads(cfg, params, batch)
        with torch.no_grad():
            new_params, new_opt = opt_step(grads, opt_state, params)
        return new_params, new_opt, {"loss": loss}

    return opt_init, train_step


def train_step(cfg: ArchConfig, params, opt_state, batch):
    _, step = make_train_step(cfg)
    return step(params, opt_state, batch)


# ========================================================= serving ==========
def cache_len_for(cfg: ArchConfig, seq_len: int) -> int:
    if cfg.has_attn and cfg.window > 0:
        return min(seq_len, cfg.window)
    return seq_len


def init_cache(cfg: ArchConfig, batch: int, seq_len: int,
               device=None) -> dict:
    check_served(cfg)
    device = resolve_device(device)
    c = cache_len_for(cfg, seq_len)
    shape = (cfg.n_layers, batch, c, cfg.n_kv_heads, cfg.hd)
    return {"pos": 0,
            "k": torch.zeros(shape, dtype=_dtype(cfg), device=device),
            "v": torch.zeros(shape, dtype=_dtype(cfg), device=device)}


def decode_step(cfg: ArchConfig, params: Params, cache: dict,
                batch: dict) -> tuple[dict, torch.Tensor]:
    """One decode step: batch {"token": (B,)} -> (cache', logits (B, V)).
    The cache's k/v are updated in place; cache' shares them."""
    check_served(cfg)
    pos = cache["pos"]
    with torch.no_grad():
        h = embed_apply(params["embed"], batch["token"][:, None],
                        _dtype(cfg))                                # (B,1,D)
        for i, lp in enumerate(_layers(params)):
            y = apply_norm(cfg.norm_kind, lp["norm1"], h)
            h = h + attn_apply_decode(lp["attn"], cfg, y,
                                      {"k": cache["k"][i],
                                       "v": cache["v"][i]}, pos)
            h = h + _ffn_sublayer(lp, cfg, h)
        h = apply_norm(cfg.norm_kind, params["final_norm"], h)
        logits = head_apply(params["head"], h)[:, 0]
    return {**cache, "pos": pos + 1}, logits


def prefill_step(cfg: ArchConfig, params: Params, batch: dict,
                 cache_len: Optional[int] = None
                 ) -> tuple[dict, torch.Tensor]:
    """Run the full prompt, build the decode cache, return last-token logits.

    With S >= C (a window ring shorter than the prompt) the cache keeps the
    last C positions at slots 0..C-1, which is the ring layout when
    S % C == 0 (the reference's assumption too); with S < C the slots past S
    stay zero until decode writes them.
    """
    check_served(cfg)
    tokens = batch["tokens"]
    b, s_len = tokens.shape
    cache = init_cache(cfg, b, cache_len or s_len, tokens.device)
    c = cache["k"].shape[2]
    with torch.no_grad():
        h = embed_apply(params["embed"], tokens, _dtype(cfg))
        for i, lp in enumerate(_layers(params)):
            y = apply_norm(cfg.norm_kind, lp["norm1"], h)
            a, (k, v) = attn_apply_seq(lp["attn"], cfg, y, return_kv=True)
            if s_len >= c:
                cache["k"][i] = k[:, -c:]
                cache["v"][i] = v[:, -c:]
            else:
                cache["k"][i, :, :s_len] = k
                cache["v"][i, :, :s_len] = v
            h = h + a
            h = h + _ffn_sublayer(lp, cfg, h)
        h = apply_norm(cfg.norm_kind, params["final_norm"], h[:, -1:])
        logits = head_apply(params["head"], h)[:, 0]
    cache["pos"] = s_len
    return cache, logits
