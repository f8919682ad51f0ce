"""Model assembly for all six LM families: init, forward, loss, train step,
prefill and decode.

Counterpart of `repro/models/lm/model.py`: dense (llama / mistral-style:
H2O-Danube-3, TinyLlama, ChatGLM3, Mistral-NeMo), MoE (Qwen3-MoE,
Kimi-K2), SSM (Mamba2), hybrid (Hymba: attention and SSM heads side by
side), encoder-decoder audio (Whisper) and the vision-prefix VLM
(InternVL2).  Params are nested dicts of tensors with the reference's keys
and shapes; layer params stay stacked on a leading L axis, as
`init_params` makes them, and the layer loop is a Python loop over views
of that axis.

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

A batch holds "tokens" (B, S), plus "patches" (B, n_frontend_tokens, D)
for the vision stub (they replace the first positions) or "frames"
(B, F, D) for the audio stub (the encoder's input).

Training is functional like the reference's: `train_step` takes the
gradients of `loss_fn` with `torch.autograd.grad` over the param leaves
(stacked layer leaves included) and returns new params and optimizer
state.  `cfg.remat` checkpoints each decoder and encoder layer (the
reference's `jax.checkpoint` of the layer body), and on the card the flash
branch runs the `flash_attention` forward and backward kernels.  `forward`
builds an autograd graph only when grad is enabled and a param requires
it; `prefill_step` and `decode_step` always serve under `no_grad`.

Decode caches: k/v are (L, B, C, Kh, hd) ring buffers (C = window for SWA
archs, O(window) memory); SSM caches are O(1) states and conv windows;
the encoder-decoder keeps its cross-attention k/v.  `pos` is the next
position, a Python int (so decode needs no host sync).  `decode_step`
writes the new token's k/v, SSM state and conv windows into the cache's
tensors in place, where the reference returns new arrays: the cache passed
in is consumed.

Under a mesh (`launch.compat.set_mesh(mesh)`, `models/lm/tp.py`) the same
entry points run one rank's part of the step: they take the global batch
and place it by the reference's `batch_specs`, and this rank's blocks of
the params, optimizer state and caches (`launch.sharding.shard_tree` by
`param_specs` / `opt_specs` / `cache_specs`).  Attention runs on the
rank's query heads and the KV heads they read (`tp.kv_index`: the local
group G' = local Hq / local Kh, also where the KV heads are replicated),
`wo` row-parallel with an all-reduce over "model"; `loss_fn` is
vocab-parallel and returns the rank's mean (`loss_and_grads` averages the
loss and the gradients over the batch axes); prefill returns its cache
placed by `cache_specs` and its logits by `logits_spec` (this rank's rows
and vocab block).  A cache whose KV heads do not divide "model" is split
on its sequence dim: decode then combines each rank's (max, sum, acc) by
all-reduce, a distributed softmax.  A rank's cache block does not show
the ring's global length, so under a mesh `decode_step` takes it
(`cache_len=`).
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models.lm.attention import (
    NEG_INF, _mask, attention, dense_attention,
)
from repro_torch.models.lm.config import ArchConfig
from repro_torch.models.lm.layers import (
    _init, apply_norm, apply_rope, cross_entropy_tokens, dense_init,
    embed_apply,
    embed_init, ffn_apply, ffn_init, head_apply, head_init, norm_init,
)
from repro_torch.models.lm import tp
from repro_torch.models.lm.moe import moe_apply, moe_init
from repro_torch.models.lm.ssm import (
    ssm_cache_init, ssm_decode_step, ssm_forward, ssm_init,
)
from repro_torch.optim import make_optimizer
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

Params = Any

MOE_AUX_WEIGHT = 0.01

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

_SSM_KEYS = ("state", "conv_x", "conv_bc")


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def _zero(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=x.device)


# ======================================================== attention =========
def attn_init(gen, cfg: ArchConfig, device=None, lead=()):
    d, hq, kh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    wo = _init(gen, (*lead, hq, hd, d), (1.0 / (hq * hd)) ** 0.5, device)
    return {
        "wq": dense_init(gen, d, (hq, hd), device, lead),
        "wk": dense_init(gen, d, (kh, hd), device, lead),
        "wv": dense_init(gen, d, (kh, hd), device, lead),
        "wo": wo,
    }


def _proj(x, w):
    """einsum("bsd,dhe->bshe", x, w) as one matmul in x's dtype."""
    d, h, e = w.shape
    return (x @ w.to(x.dtype).reshape(d, h * e)).unflatten(-1, (h, e))


def _out(o, w):
    """einsum("bshe,hed->bsd", o, w) as one matmul in o's dtype."""
    h, e, d = w.shape
    return o.flatten(-2) @ w.to(o.dtype).reshape(h * e, d)


class _Weights(NamedTuple):
    wq: torch.Tensor
    wk: torch.Tensor
    wv: torch.Tensor
    wo: torch.Tensor
    q_split: bool       # this rank holds a block of the query heads (and
    kv_split: bool      # of wo's rows); of the KV heads


def _weights(p, part: str = "attn") -> _Weights:
    """The weights of `part` ("attn" or "cross_attn") with FSDP's "data"
    dims gathered, and which heads the mesh's rules split."""
    return _Weights(*(tp.full(p[n], f"{part}/{n}")
                      for n in ("wq", "wk", "wv", "wo")),
                    tp.split(f"{part}/wq", 1), tp.split(f"{part}/wk", 1))


def _qkv(w: _Weights, x, kv_x=None, *, cfg, rope: bool, q_pos, kv_pos):
    wk, wv = w.wk, w.wv
    kv_x = x if kv_x is None else kv_x
    if w.q_split:
        x, kv_x = tp.enter(x), tp.enter(kv_x)
        if not w.kv_split:
            # replicated KV heads of which this rank reads a part
            wk, wv = tp.enter(wk), tp.enter(wv)
    q = _proj(x, w.wq)
    k = _proj(kv_x, wk)
    v = _proj(kv_x, wv)
    if rope:
        q = apply_rope(q, q_pos, frac=cfg.rope_frac, theta=cfg.rope_theta)
        k = apply_rope(k, kv_pos, frac=cfg.rope_frac, theta=cfg.rope_theta)
    return q, k, v


def _local_kv(cfg: ArchConfig, w: _Weights, q, k, v):
    """k / v at the KV heads that this rank's query heads read, when the
    query heads are a block and the KV heads whole here (G' = local Hq /
    local Kh; `tp.kv_index`)."""
    if not w.q_split or w.kv_split:
        return k, v
    heads, _ = tp.kv_index(tp.model_index() * q.shape[2], q.shape[2],
                           cfg.n_heads // cfg.n_kv_heads)
    return tp.take_heads(k, heads), tp.take_heads(v, heads)


def _out_proj(o, w):
    """o @ wo, all-reduced over "model" when wo is row-parallel."""
    y = _out(o, w.wo)
    return tp.leave(y) if w.q_split else y


def attn_apply_seq(p, cfg: ArchConfig, x, *, causal=True, rope=True,
                   kv_x=None, return_kv=False, part="attn"):
    """Full-sequence path (train / prefill / encoder / cross-attention
    against `kv_x`, `part` "cross_attn").  With `return_kv`, the k / v of
    the KV heads this rank holds (all of them where wk is replicated)."""
    q_pos = torch.arange(x.shape[1], device=x.device)
    kv_pos = (q_pos if kv_x is None else
              torch.arange(kv_x.shape[1], device=x.device))
    w = _weights(p, part)
    q, k, v = _qkv(w, x, kv_x, cfg=cfg, rope=rope, q_pos=q_pos,
                   kv_pos=kv_pos)
    ka, va = _local_kv(cfg, w, q, k, v)
    o = attention(q, ka, va, q_pos=q_pos, kv_pos=kv_pos, causal=causal,
                  window=cfg.window, impl=cfg.attn_impl,
                  kv_chunk=cfg.attn_chunk, remat=cfg.attn_remat)
    y = _out_proj(o, w)
    return (y, (k, v)) if return_kv else y


def _ring_positions(pos: int, cache_len: int, device=None) -> torch.Tensor:
    """Absolute position stored in each ring slot; negative => unwritten."""
    s = torch.arange(cache_len, device=device)
    return pos - torch.remainder(pos - s, cache_len)


def _kv_layout(cfg: ArchConfig, name: str, length: int) -> str:
    """How `cache_specs` places cache leaf `name` ("k", "cross_k") of
    global `length` positions: "heads" (a block of the KV heads), "seq" (a
    block of the positions) or "full"."""
    if tp.layout() is None:
        return "full"
    spec = tp.cache_spec(cfg, name, length)          # (B, C, Kh, hd)
    if spec[2] == tp.MODEL:
        return "heads"
    return "seq" if spec[1] == tp.MODEL else "full"


def _to_cache(t, c_len: int, layout: str, kv_split: bool) -> torch.Tensor:
    """k or v (B, S, Kh, hd), with this rank's KV heads when `kv_split`,
    as the ring's block: the last `c_len` positions at slots 0 .. c_len - 1
    (zeros past S), then this rank's block of the KV heads or positions
    where the cache's `layout` holds one."""
    s_len = t.shape[1]
    if s_len >= c_len:
        ring = t[:, s_len - c_len:]
    else:
        ring = t.new_zeros((t.shape[0], c_len, *t.shape[2:]))
        ring[:, :s_len] = t
    if layout == "heads" and not kv_split:
        ring = tp.block(ring, 2)
    if layout == "seq":
        ring = tp.block(ring, 1)
    return ring


def _seq_attention(q, k, v, *, q_pos, kv_pos, causal, window, kv_valid):
    """Attention over a cache split on its positions across "model": each
    rank's (max, sum, acc) over its own positions, combined by an
    all-reduce of the max and one of (acc, sum): a distributed softmax.
    q (B, S, Hq, hd) with every query head; k / v (B, C_l, Kh, hd)."""
    from repro_torch.launch import collectives as C
    mesh = tp.layout().mesh
    b, s_len, hq, hd = q.shape
    kh = k.shape[2]
    qg = q.reshape(b, s_len, kh, hq // kh, hd).to(torch.float32)
    s = torch.einsum("bskgd,btkd->bkgst", qg, k.to(torch.float32)) \
        * hd ** -0.5
    mask = _mask(q_pos, kv_pos, causal=causal, window=window,
                 kv_valid=kv_valid)
    s = torch.where(mask[None, None, None], s, NEG_INF)
    m = C.all_reduce(s.amax(-1), tp.MODEL, "max", mesh=mesh)
    p = torch.exp(s - m[..., None])
    acc = torch.einsum("bkgst,btkd->bkgsd", p, v.to(torch.float32))
    tot = C.all_reduce(torch.cat([acc, p.sum(-1)[..., None]], -1),
                       tp.MODEL, mesh=mesh)
    o = tot[..., :hd] / tot[..., hd:]
    return torch.movedim(o, 3, 1).reshape(b, s_len, hq, hd).to(q.dtype)


def _decode_attend(cfg: ArchConfig, w: _Weights, q, kc, vc, *, q_pos,
                   kv_pos, layout: str, causal: bool, window: int,
                   kv_valid=None):
    """One decode token's attention against a cache block in `layout`,
    through wo: (B, 1, D)."""
    from repro_torch.launch import collectives as C
    q_split = w.q_split
    if layout == "seq":
        if q_split:          # every query head, against this rank's slots
            q = C.all_gather(q, tp.MODEL, 2, mesh=tp.layout().mesh)
        o = _seq_attention(q, kc, vc, q_pos=q_pos, kv_pos=kv_pos,
                           causal=causal, window=window, kv_valid=kv_valid)
        if q_split:
            o = tp.block(o, 2)
        return _out_proj(o, w)
    if layout == "heads" and not q_split:
        # a block of KV heads under replicated weights: its query heads,
        # then every head's output gathered
        o = dense_attention(tp.block(q, 2), kc, vc, q_pos=q_pos,
                            kv_pos=kv_pos, causal=causal, window=window,
                            kv_valid=kv_valid)
        o = C.all_gather(o, tp.MODEL, 2, mesh=tp.layout().mesh)
        return _out_proj(o, w)
    kc, vc = _local_kv(cfg, w, q, kc, vc)
    o = dense_attention(q, kc, vc, q_pos=q_pos, kv_pos=kv_pos, causal=causal,
                        window=window, kv_valid=kv_valid)
    return _out_proj(o, w)


def attn_apply_decode(p, cfg: ArchConfig, x, kv_cache, pos: int,
                      c_len: int):
    """One-token decode. x (B, 1, D); kv_cache {k,v}: (B, C, Kh, hd) (this
    rank's block under a mesh) of a ring of `c_len` positions, written in
    place at slot pos % c_len by the rank that holds it."""
    w = _weights(p)
    # a fill on the device: torch.tensor([pos]) would copy from pageable
    # host memory, which waits for the card's queue at every layer
    q_pos = torch.full((1,), pos, dtype=torch.int64, device=x.device)
    q, k_new, v_new = _qkv(w, x, cfg=cfg, rope=True, q_pos=q_pos,
                           kv_pos=q_pos)
    kc, vc = kv_cache["k"], kv_cache["v"]
    layout = _kv_layout(cfg, "k", c_len)
    slot = pos % c_len
    if layout == "heads" and not w.kv_split:
        k_new, v_new = tp.block(k_new, 2), tp.block(v_new, 2)
    lo = tp.model_index() * kc.shape[1] if layout == "seq" else 0
    if lo <= slot < lo + kc.shape[1]:
        kc[:, slot - lo] = k_new[:, 0].to(kc.dtype)
        vc[:, slot - lo] = v_new[:, 0].to(vc.dtype)
    kv_pos = _ring_positions(pos, c_len, x.device)[lo:lo + kc.shape[1]]
    return _decode_attend(cfg, w, q, kc, vc, q_pos=q_pos, kv_pos=kv_pos,
                          layout=layout, causal=True, window=cfg.window,
                          kv_valid=kv_pos >= 0)


def attn_apply_cross_decode(p, cfg: ArchConfig, x, cross_kv):
    """Decoder cross-attention against a fixed encoder cache (no
    causality, no rope)."""
    k, v = cross_kv["k"], cross_kv["v"]
    w = _weights(p, "cross_attn")
    q = _proj(x, w.wq)
    layout = _kv_layout(cfg, "cross_k", cfg.n_frontend_tokens)
    lo = tp.model_index() * k.shape[1] if layout == "seq" else 0
    return _decode_attend(
        cfg, w, q, k, v,
        q_pos=torch.zeros((1,), dtype=torch.int64, device=x.device),
        kv_pos=torch.arange(lo, lo + k.shape[1], device=x.device),
        layout=layout, causal=False, window=0)


# ====================================================== layer blocks ========
def layer_init(gen, cfg: ArchConfig, device=None, lead=()):
    """One layer's params, or `lead`-stacked layers' (the reference vmaps
    `layer_init` over the layer keys; here each leaf is drawn stacked)."""
    p = {"norm1": norm_init(cfg.d_model, device, lead)}
    if cfg.has_attn:
        p["attn"] = attn_init(gen, cfg, device, lead)
    if cfg.has_ssm:
        p["ssm"] = ssm_init(gen, cfg, device, lead)
    if cfg.family == "hybrid":
        p["attn_out_norm"] = norm_init(cfg.d_model, device, lead)
        p["ssm_out_norm"] = norm_init(cfg.d_model, device, lead)
    if cfg.is_moe:
        p["norm2"] = norm_init(cfg.d_model, device, lead)
        p["moe"] = moe_init(gen, cfg, device, lead)
    elif cfg.d_ff > 0:
        p["norm2"] = norm_init(cfg.d_model, device, lead)
        p["ffn"] = ffn_init(gen, cfg.d_model, cfg.d_ff, cfg.ffn_kind, device,
                            lead)
    if cfg.encoder_layers:      # decoder layer of an enc-dec model
        p["cross_norm"] = norm_init(cfg.d_model, device, lead)
        p["cross_attn"] = attn_init(gen, cfg, device, lead)
    return p


def _mix(p, cfg: ArchConfig, a, s):
    """A layer's token mix from its attention output `a` and its SSM output
    `s` (None where it has none): the hybrid's 0.5 * (norm(a) + norm(s)),
    else the one it has.  Forward, prefill and decode all mix here."""
    if cfg.family == "hybrid":
        a = apply_norm(cfg.norm_kind, p["attn_out_norm"], a)
        s = apply_norm(cfg.norm_kind, p["ssm_out_norm"], s)
        return 0.5 * (a + s)
    return s if cfg.has_ssm else a


def _mix_sublayer(p, cfg: ArchConfig, x):
    """Token-mixing sublayer on the *normed* input (full-sequence path)."""
    h = apply_norm(cfg.norm_kind, p["norm1"], x)
    a = attn_apply_seq(p["attn"], cfg, h) if cfg.has_attn else None
    s = ssm_forward(p["ssm"], cfg, h) if cfg.has_ssm else None
    return _mix(p, cfg, a, s)


def _ffn_sublayer(p, cfg: ArchConfig, x):
    """(FFN or MoE output, aux load-balance loss (0 but for MoE))."""
    if cfg.is_moe:
        h = apply_norm(cfg.norm_kind, p["norm2"], x)
        return moe_apply(p["moe"], cfg, h, n_groups=cfg.moe_groups)
    if cfg.d_ff > 0:
        h = apply_norm(cfg.norm_kind, p["norm2"], x)
        return ffn_apply(p["ffn"], h, cfg.ffn_kind), _zero(x)
    return torch.zeros_like(x), _zero(x)


def _cross_sublayer(p, cfg: ArchConfig, x, cross_x):
    h = apply_norm(cfg.norm_kind, p["cross_norm"], x)
    return attn_apply_seq(p["cross_attn"], cfg, h, kv_x=cross_x,
                          causal=False, rope=False, part="cross_attn")


def decoder_layer(p, cfg: ArchConfig, x, cross_x=None):
    x = x + _mix_sublayer(p, cfg, x)
    if cfg.encoder_layers and cross_x is not None:
        x = x + _cross_sublayer(p, cfg, x, cross_x)
    y, aux = _ffn_sublayer(p, cfg, x)
    return x + y, aux


def encoder_layer(p, cfg: ArchConfig, x):
    h = apply_norm(cfg.norm_kind, p["norm1"], x)
    x = x + attn_apply_seq(p["attn"], cfg, h, causal=False, rope=False)
    y, aux = _ffn_sublayer(p, cfg, x)
    return x + y, aux


def _layers(stacked: Params) -> list:
    """Every layer's params as views of the stacked leaves, by one unbind a
    leaf: its backward stacks the layers' gradients in one copy, where a
    select a layer would add an (L, ...) buffer of zeros a layer."""
    cols = tree_map(lambda t: t.unbind(0), stacked)
    n = tree_leaves(stacked)[0].shape[0]
    return [tree_map(lambda c: c[i], cols) for i in range(n)]


def _run_layers(cfg: ArchConfig, stacked: Params, x, layer_fn, *args):
    """`layer_fn(lp, cfg, x, *args) -> (x, aux)` over the stacked layers,
    each checkpointed under grad when `cfg.remat`; returns (x, summed aux).
    """
    remat = cfg.remat and torch.is_grad_enabled()
    auxs = []
    x = tp.constrain(cfg, x, ("batch", None, None))
    for lp in _layers(stacked):
        if remat:
            # the layer draws nothing, so no RNG state needs keeping
            x, aux = checkpoint(layer_fn, lp, cfg, x, *args,
                                use_reentrant=False, preserve_rng_state=False)
        else:
            x, aux = layer_fn(lp, cfg, x, *args)
        x = tp.constrain(cfg, x, ("batch", None, None))
        auxs.append(aux)
    return x, torch.sum(torch.stack(auxs))


# ===================================================== init / forward =======
def _sinusoid(n: int, d: int, dtype, device=None) -> torch.Tensor:
    """(n, d) sine / cosine positions.  Computed on the CPU and then moved,
    so that the card's table is the CPU's bit for bit (angles reach ~n
    radians, where one ulp of the angle is visible in the sine)."""
    pos = torch.arange(n, dtype=torch.float32)[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32)[None, :]
    ang = pos / (10000.0 ** (dim / d))
    pe = torch.zeros((n, d), dtype=torch.float32)
    pe[:, 0::2] = torch.sin(ang)
    pe[:, 1::2] = torch.cos(ang)
    return pe.to(device=device, dtype=dtype)


def init_params(cfg: ArchConfig, gen: torch.Generator,
                device=None) -> Params:
    """Random params in the reference's tree, drawn from `gen` on its own
    device and stored on `device` (default: the CUDA card; on `meta`
    nothing is drawn or allocated, the tree's shapes and dtypes only).  A generator
    on the card draws a full-width model in well under a second; a CPU
    generator takes tens of seconds for billions of normals.  The numbers
    differ from the reference's threefry draws: carry weights across with
    `repro_torch.interop` to compare the two."""
    device = resolve_device(device)
    params = {
        "embed": embed_init(gen, cfg.vocab, cfg.d_model, device),
        "layers": layer_init(gen, cfg, device, lead=(cfg.n_layers,)),
        "final_norm": norm_init(cfg.d_model, device),
        "head": head_init(gen, cfg.d_model, cfg.vocab, device),
    }
    if cfg.encoder_layers:
        # same width; encoder layers have no cross-attention
        lead = (cfg.encoder_layers,)
        params["enc_layers"] = {
            "norm1": norm_init(cfg.d_model, device, lead),
            "attn": attn_init(gen, cfg, device, lead),
            "norm2": norm_init(cfg.d_model, device, lead),
            "ffn": ffn_init(gen, cfg.d_model, cfg.d_ff, cfg.ffn_kind, device,
                            lead),
        }
        params["enc_norm"] = norm_init(cfg.d_model, device)
    pdt = _DTYPES[cfg.param_dtype]
    if pdt != torch.float32:
        params = tree_map(lambda x: x.to(pdt), params)
    return params


def encode(cfg: ArchConfig, params: Params, frames: torch.Tensor
           ) -> torch.Tensor:
    """Whisper encoder over stub conv-frontend frames (B, F, D)."""
    dt = _dtype(cfg)
    x = frames.to(dt) + _sinusoid(frames.shape[1], cfg.d_model, dt,
                                  frames.device)[None]
    x, _ = _run_layers(cfg, params["enc_layers"], x, encoder_layer)
    return apply_norm(cfg.norm_kind, params["enc_norm"], x)


def _embed(cfg: ArchConfig, params: Params, batch: dict):
    """The decoder's input (B, S, D) and the encoder's output (or None):
    token embeddings, the vision patches over the first positions, or the
    audio encoder plus the decoder's sinusoid."""
    dt = _dtype(cfg)
    tokens = batch["tokens"]
    x = embed_apply(params["embed"], tokens, dt)
    if cfg.frontend == "vision":
        # stub ViT frontend: precomputed patch embeddings replace the first
        # n_frontend_tokens positions (image-prefix interleave)
        patches = batch["patches"].to(dt)
        x = torch.cat([patches, x[:, patches.shape[1]:]], dim=1)
    cross = None
    if cfg.encoder_layers:
        cross = encode(cfg, params, batch["frames"])
        x = x + _sinusoid(x.shape[1], cfg.d_model, dt, x.device)[None]
    return x, cross


def forward(cfg: ArchConfig, params: Params,
            batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward. Returns (logits (B,S,V) f32, MoE aux loss
    summed over layers).  Under grad, `cfg.remat` recomputes each layer in
    the backward pass.  Under a mesh: this rank's rows and vocab block."""
    with tp.placed(cfg, batch, "tokens") as batch:
        x, cross = _embed(cfg, params, batch)
        x, aux = _run_layers(cfg, params["layers"], x, decoder_layer, cross)
        x = apply_norm(cfg.norm_kind, params["final_norm"], x)
        return head_apply(params["head"], x), aux


def loss_fn(cfg: ArchConfig, params: Params, batch: dict) -> torch.Tensor:
    """Mean next-token cross entropy (over the text positions only for the
    vision stub) plus MOE_AUX_WEIGHT times the MoE aux loss.  Under a mesh
    the mean over this rank's rows, vocab-parallel where the head is."""
    with tp.placed(cfg, batch, "tokens") as batch:
        logits, aux = forward(cfg, params, batch)
        labels = batch["tokens"][:, 1:]
        if cfg.frontend == "vision":
            # only text positions contribute to the LM loss
            mask = (torch.arange(labels.shape[1],
                                 device=labels.device)[None, :]
                    >= cfg.n_frontend_tokens).expand(labels.shape)
        else:
            mask = torch.ones(labels.shape, dtype=torch.bool,
                              device=labels.device)
        loss = tp.vocab_parallel_ce(logits[:, :-1], labels, mask)
        if loss is None:
            loss = cross_entropy_tokens(logits[:, :-1], labels, mask)
        return loss + MOE_AUX_WEIGHT * aux


def loss_and_grads(cfg: ArchConfig, params: Params,
                   batch: dict) -> tuple[torch.Tensor, Params]:
    """`loss_fn` and its gradient tree (the reference's
    `jax.value_and_grad`), by `torch.autograd.grad` over the param leaves;
    `params` themselves are not touched.  Under a mesh: the global batch's
    mean loss, and this rank's blocks of its gradient (each summed over
    the batch axes its leaf is not split over, `tp.sync_grads`)."""
    leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
    with tp.placed(cfg, batch, "tokens") as batch:
        with torch.enable_grad():
            loss = loss_fn(cfg, tree_unflatten(params, leaves), batch)
            grads = torch.autograd.grad(loss, leaves)
        lay = tp.layout()
        if lay is not None:
            specs = tree_leaves(tp.param_specs_of(cfg, lay.mesh))
            grads = tp.sync_grads(list(grads), specs)
            loss = tp.mean_over_batch(loss.detach())
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


def init_cache(cfg: ArchConfig, batch: int, seq_len: int, device=None,
               cross_len: Optional[int] = None) -> dict:
    """Zeroed caches: k/v rings with attention, `ssm_*` states and conv
    windows with an SSM, and `cross_k` / `cross_v` of `cross_len` encoder
    positions (default n_frontend_tokens) for an encoder-decoder."""
    device = resolve_device(device)
    lay = tp.layout()
    if lay is None:
        return _whole_cache(cfg, batch, seq_len, device, cross_len)
    # under a mesh: this rank's blocks of the global cache, by cache_specs
    from repro_torch.launch.sharding import cache_specs, shard_tree
    with tp.uncounted():
        whole = _whole_cache(cfg, batch, seq_len, torch.device("meta"),
                             cross_len)
        local = shard_tree(whole, cache_specs(cfg, lay.mesh, whole),
                           lay.mesh)
    return {k: (torch.zeros(v.shape, dtype=v.dtype, device=device)
                if isinstance(v, torch.Tensor) else v)
            for k, v in local.items()}


def _whole_cache(cfg: ArchConfig, batch: int, seq_len: int, device,
                 cross_len: Optional[int]) -> dict:
    dt, n_layers = _dtype(cfg), cfg.n_layers
    cache: dict = {"pos": 0}
    if cfg.has_attn:
        shape = (n_layers, batch, cache_len_for(cfg, seq_len),
                 cfg.n_kv_heads, cfg.hd)
        cache["k"] = torch.zeros(shape, dtype=dt, device=device)
        cache["v"] = torch.zeros(shape, dtype=dt, device=device)
    if cfg.has_ssm:
        for k, v in ssm_cache_init(cfg, batch, dt).items():
            cache[f"ssm_{k}"] = torch.zeros((n_layers, *v.shape),
                                            dtype=v.dtype, device=device)
    if cfg.encoder_layers:
        shape = (n_layers, batch, cross_len or cfg.n_frontend_tokens,
                 cfg.n_kv_heads, cfg.hd)
        cache["cross_k"] = torch.zeros(shape, dtype=dt, device=device)
        cache["cross_v"] = torch.zeros(shape, dtype=dt, device=device)
    return cache


def decode_step(cfg: ArchConfig, params: Params, cache: dict,
                batch: dict, *, cache_len: Optional[int] = None
                ) -> tuple[dict, torch.Tensor]:
    """One decode step: batch {"token": (B,)} -> (cache', logits (B, V)).
    The cache's tensors are updated in place; cache' shares them.  Like the
    reference, the decoder adds no sinusoid here (Whisper's decode logits
    therefore differ from its forward's).  Under a mesh: the global tokens,
    this rank's cache blocks, its rows and vocab block of the logits.
    `cache_len` is the length the cache was built for (`init_cache`'s or
    `prefill_step`'s; the ring holds `cache_len_for` of it): under a mesh
    a rank's block does not show it, and `cache_specs` places the ring by
    it, so there a model with attention needs it."""
    pos = cache["pos"]
    with torch.no_grad(), tp.placed(cfg, batch, "token") as batch:
        c_len = None
        if cfg.has_attn:
            if cache_len is None and tp.layout() is not None:
                raise ValueError("decode_step under a mesh needs the "
                                 "cache's global length (cache_len=)")
            c_len = cache["k"].shape[2] if cache_len is None \
                else cache_len_for(cfg, cache_len)
        h = embed_apply(params["embed"], batch["token"][:, None],
                        _dtype(cfg))                                # (B,1,D)
        for i, lp in enumerate(_layers(params["layers"])):
            y = apply_norm(cfg.norm_kind, lp["norm1"], h)
            a = s = None
            if cfg.has_attn:
                a = attn_apply_decode(lp["attn"], cfg, y,
                                      {"k": cache["k"][i],
                                       "v": cache["v"][i]}, pos, c_len)
            if cfg.has_ssm:
                s, st = ssm_decode_step(lp["ssm"], cfg, y[:, 0], {
                    k: cache[f"ssm_{k}"][i] for k in _SSM_KEYS})
                for k in _SSM_KEYS:
                    cache[f"ssm_{k}"][i].copy_(st[k])
                s = s[:, None]
            h = h + _mix(lp, cfg, a, s)
            if cfg.encoder_layers:
                hc = apply_norm(cfg.norm_kind, lp["cross_norm"], h)
                h = h + attn_apply_cross_decode(
                    lp["cross_attn"], cfg, hc,
                    {"k": cache["cross_k"][i], "v": cache["cross_v"][i]})
            h = h + _ffn_sublayer(lp, cfg, h)[0]
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
    stay zero until decode writes them.  SSM layers store the state after
    the last chunk and the last conv windows; an encoder-decoder stores each
    layer's cross-attention k/v of the encoder's output.  Under a mesh the
    cache comes back placed by `cache_specs` and the logits by
    `logits_spec`.
    """
    b, s_len = batch["tokens"].shape
    c_len = cache_len_for(cfg, cache_len or s_len)
    with torch.no_grad(), tp.placed(cfg, batch, "tokens") as batch:
        tokens = batch["tokens"]
        h, cross = _embed(cfg, params, batch)
        cache = init_cache(cfg, b, cache_len or s_len, tokens.device,
                           cross_len=None if cross is None
                           else cross.shape[1])
        kv_layout = _kv_layout(cfg, "k", c_len)
        cross_layout = None if cross is None else \
            _kv_layout(cfg, "cross_k", cross.shape[1])
        for i, lp in enumerate(_layers(params["layers"])):
            y = apply_norm(cfg.norm_kind, lp["norm1"], h)
            a = s = None
            if cfg.has_attn:
                a, (k, v) = attn_apply_seq(lp["attn"], cfg, y,
                                           return_kv=True)
                split = tp.split("attn/wk", 1)
                cache["k"][i] = _to_cache(k, c_len, kv_layout, split)
                cache["v"][i] = _to_cache(v, c_len, kv_layout, split)
            if cfg.has_ssm:
                s, state = ssm_forward(lp["ssm"], cfg, y, with_state=True)
                for k, t in zip(_SSM_KEYS, state):
                    cache[f"ssm_{k}"][i] = t
            h = h + _mix(lp, cfg, a, s)
            if cross is not None:
                h = h + _cross_sublayer(lp, cfg, h, cross)
                w = _weights(lp["cross_attn"], "cross_attn")
                for name, wt in (("cross_k", w.wk), ("cross_v", w.wv)):
                    cache[name][i] = _to_cache(_proj(cross, wt),
                                               cross.shape[1], cross_layout,
                                               w.kv_split)
            h = h + _ffn_sublayer(lp, cfg, h)[0]
        h = apply_norm(cfg.norm_kind, params["final_norm"], h[:, -1:])
        logits = head_apply(params["head"], h)[:, 0]
    cache["pos"] = s_len
    return cache, logits
