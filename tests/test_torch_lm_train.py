"""The port's LM training path against the reference's, on the CPU: AdamW /
SGD, the flash backward's plain version and `FlashAttentionFn`, the flash
branch's gradients, `loss_fn` and its gradients, `train_step`, remat, the
launcher and the federated LM example.

Reference and port get the same numpy inputs from a seed; params and
optimizer states are carried across by `repro_torch.interop`.
Tolerances (float32 throughout): optimizer steps at 1e-6 (the same
operations in the same order); attention gradients at 2e-5 times the
largest gradient (the forward's 2e-5, sums in another order); `loss_fn`
at 1e-5 relative and its gradients at 1e-4 times each leaf's largest
gradient (two layers of float32 products in another order; measured
~2e-6); params after 3 SGD steps at 1e-6, after 3 AdamW steps at 1e-5
for all but 1e-3 of each leaf and within 2 lr a step for all (AdamW's
m / sqrt(v) turns a last-bit difference of a gradient that is ~0 into
up to a step of the opposite sign; measured 1.8e-4 on 1 of 4096).
"""
import dataclasses
import importlib.util
import re
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels.flash_attention.ref import attention_ref as jax_attn_ref
from repro.models.lm import attention as jattn
from repro.models.lm import model as JM
from repro.optim import make_optimizer as jax_make_optimizer
from repro_torch import kernels
from repro_torch.interop import params_from_numpy, params_to_numpy
from repro_torch.kernels.flash_attention import (
    FlashAttentionFn, attention_bwd_bf16_ref, attention_bwd_bf16_slack,
    attention_bwd_gqa_ref, attention_ref, flash_attention_gqa,
)
from repro_torch.launch import train as launch_train
from repro_torch.models.lm import attention as tattn
from repro_torch.models.lm import config as tconfig
from repro_torch.models.lm import model as TM
from repro_torch.optim import AdamWState, SGDState, make_optimizer
from repro_torch.tree import tree_leaves, tree_paths

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs six test files at once; at these small sizes torch's
    intra-op threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _assert_grads_close(got, want, rel):
    """Each gradient within `rel` times its own largest entry."""
    for g, w in zip(got, want):
        g, w = _f32(g), _f32(w)
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=rel * max(float(np.abs(w).max()),
                                                  1e-30))


# ------------------------------------------------------------ optimizers --
def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": {"w": rng.standard_normal((5, 7)).astype(np.float32)},
            "b": rng.standard_normal((11,)).astype(np.float32)}


@pytest.mark.parametrize("name,kw", [
    ("adamw", {"lr": 1e-2, "weight_decay": 0.1}),
    ("adamw", {}),
    ("sgd", {"lr": 0.05, "momentum": 0.5})])
def test_optimizer_steps_match_the_reference(name, kw):
    """3 steps of `make_optimizer` from the reference's state carried
    across: params and every state leaf at 1e-6."""
    j_init, j_step = jax_make_optimizer(name, **kw)
    t_init, t_step = make_optimizer(name, **kw)
    params = _tree(0)
    jp = jax.tree.map(jnp.asarray, params)
    js = j_init(jp)
    tp = params_from_numpy(params)
    ts = params_from_numpy(_np(js))
    assert type(ts) is (AdamWState if name == "adamw" else SGDState)
    for i in range(3):
        grads = _tree(i + 1)
        jp, js = j_step(jax.tree.map(jnp.asarray, grads), js, jp)
        tp, ts = t_step(params_from_numpy(grads), ts, tp)
    for a, b in zip(tree_leaves(tp), jax.tree.leaves(jp)):
        np.testing.assert_allclose(_f32(a), _f32(b), atol=1e-6, rtol=0)
    for field, jfield in zip(ts, js):
        for a, b in zip(tree_leaves(field), jax.tree.leaves(jfield)):
            assert a.dtype == torch.from_numpy(np.array(b)).dtype
            np.testing.assert_allclose(_f32(a), _f32(b), atol=1e-6, rtol=0)


def test_interop_carries_optimizer_states_both_ways():
    p = params_from_numpy(_tree(3))
    state = make_optimizer("adamw")[0](p)
    assert state.step.dtype == torch.int32 and state.step.shape == ()
    back = params_to_numpy(state)
    assert type(back) is AdamWState and isinstance(back.mu["b"], np.ndarray)
    again = params_from_numpy(back)
    assert type(again) is AdamWState
    assert tree_paths(again.nu) == tree_paths(p)
    with pytest.raises(ValueError, match="unknown optimizer"):
        make_optimizer("lion")


# ------------------------------------------------------ flash backward ----
def _qkv(seed, b, s, t, hq, kh, hd, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(dtype) for shape in
            ((b, s, hq, hd), (b, t, kh, hd), (b, t, kh, hd),
             (b, s, hq, hd))]


BWD_CASES = [  # b, s, t, hq, kh, hd, causal, window, q_pos offset
    (2, 40, 40, 4, 1, 8, True, 0, 0), (1, 37, 37, 4, 4, 16, True, 9, 0),
    (2, 33, 33, 2, 2, 8, False, 0, 0), (1, 45, 45, 8, 2, 8, False, 12, 0),
    (1, 20, 60, 4, 1, 8, True, 0, 40), (2, 19, 50, 4, 4, 8, True, 16, 31)]


@pytest.mark.parametrize("b,s,t,hq,kh,hd,causal,win,off", BWD_CASES)
def test_attention_bwd_ref_matches_autograd_and_jax(b, s, t, hq, kh, hd,
                                                    causal, win, off):
    """`attention_bwd_ref` (through its GQA layout) against torch autograd
    of `attention_ref`, `jax.grad` of the reference model's
    `dense_attention` (q_pos offsets), and `jax.grad` of the reference
    kernel's `attention_ref` where positions start at 0 and S = T."""
    q, k, v, do = _qkv(s + t + hd + win, b, s, t, hq, kh, hd)
    pos = np.arange(off, off + s)
    qt, kt, vt = (_t(x).requires_grad_() for x in (q, k, v))
    o = flash_attention_gqa(qt, kt, vt, q_pos=_t(pos), causal=causal,
                            window=win)
    auto = torch.autograd.grad(o, (qt, kt, vt), _t(do))
    # the plain backward on the forward's o and lse
    g = hq // kh
    heads = lambda x: _t(x).transpose(1, 2).flatten(0, 1)
    o_ref, lse = attention_ref(
        heads(q), heads(k).repeat_interleave(g, 0),
        heads(v).repeat_interleave(g, 0), causal=causal, window=win,
        q_pos=_t(pos), with_lse=True)
    o_ref = o_ref.unflatten(0, (b, hq)).transpose(1, 2)
    got = attention_bwd_gqa_ref(*(_t(x) for x in (q, k, v)), o_ref, _t(do),
                                lse.unflatten(0, (b, hq)), q_pos=_t(pos),
                                causal=causal, window=win)
    _assert_grads_close(got, auto, 2e-5)

    def jloss(q_, k_, v_):
        out = jattn.dense_attention(q_, k_, v_, q_pos=jnp.asarray(pos),
                                    kv_pos=jnp.arange(t), causal=causal,
                                    window=win)
        return jnp.sum(out * jnp.asarray(do))
    want = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(
        *map(jnp.asarray, (q, k, v)))
    _assert_grads_close(got, want, 2e-5)
    if off == 0 and s == t:
        def kloss(q_, k_, v_):       # (BH, S, hd), KV repeated per group
            rep = lambda x: jnp.repeat(x.transpose(0, 2, 1, 3), g, 1
                                       ).reshape(b * hq, t, hd)
            out = jax_attn_ref(q_.transpose(0, 2, 1, 3).reshape(b * hq, s,
                                                                 hd),
                               rep(k_), rep(v_), causal=causal, window=win)
            return jnp.sum(out.reshape(b, hq, s, hd).transpose(0, 2, 1, 3)
                           * jnp.asarray(do))
        want = jax.jit(jax.grad(kloss, argnums=(0, 1, 2)))(
            *map(jnp.asarray, (q, k, v)))
        _assert_grads_close(got, want, 2e-5)


def _bf16_valued(x):
    """x rounded to bf16 and kept as float32: the bf16 route's inputs."""
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


def _plain_o_lse(q, k, v, pos, causal, win):
    """The plain forward's o (B, S, Hq, hd) and lse (B, Hq, S)."""
    b, hq, g = q.shape[0], q.shape[2], q.shape[2] // k.shape[2]
    heads = lambda x: _t(x).transpose(1, 2).flatten(0, 1)
    o, lse = attention_ref(
        heads(q), heads(k).repeat_interleave(g, 0),
        heads(v).repeat_interleave(g, 0), causal=causal, window=win,
        q_pos=_t(pos), with_lse=True)
    return o.unflatten(0, (b, hq)).transpose(1, 2), lse.unflatten(0, (b, hq))


BF16_CASES = BWD_CASES + [  # and at widths where sums are long
    (1, 256, 256, 8, 1, 64, True, 0, 0), (1, 200, 260, 4, 2, 120, True, 64,
                                          60),
    # the wide tensor-core kernels' widths (hd padded to 256), G = 2,
    # windows that cut their 64-key tiles
    (1, 200, 200, 4, 2, 160, True, 100, 0),
    (1, 180, 260, 4, 2, 256, True, 90, 80)]


@pytest.mark.parametrize("b,s,t,hq,kh,hd,causal,win,off", BF16_CASES)
def test_bf16_backward_arithmetic_departs_within_its_bound(b, s, t, hq, kh,
                                                           hd, causal, win,
                                                           off):
    """`attention_bwd_bf16_ref` (the bf16 kernel's arithmetic: P and dS
    rounded to bf16 before the products that read them, float32 sums) on
    bf16-valued inputs against `jax.grad` of the reference's
    `dense_attention` on the same values in float32: within the departure
    bound the bf16 kernel is held to on the card, per element |err| <=
    2^-7 |grad| + 2^-8 max |grad| and mean |err| <= 2^-8 mean |grad|
    (rounding P and dS moves each term of a sum by at most 2^-9)."""
    q, k, v, do = map(_bf16_valued, _qkv(s + t + hd + win, b, s, t, hq, kh,
                                         hd))
    pos = np.arange(off, off + s)
    o, lse = _plain_o_lse(q, k, v, pos, causal, win)
    got = attention_bwd_gqa_ref(*(_t(x) for x in (q, k, v)), o, _t(do), lse,
                                q_pos=_t(pos), causal=causal, window=win,
                                plain=attention_bwd_bf16_ref)

    def jloss(q_, k_, v_):
        out = jattn.dense_attention(q_, k_, v_, q_pos=jnp.asarray(pos),
                                    kv_pos=jnp.arange(t), causal=causal,
                                    window=win)
        return jnp.sum(out * jnp.asarray(do))
    want = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(
        *map(jnp.asarray, (q, k, v)))
    for g, w in zip(got, want):
        g, w = _f32(g), _f32(w)
        err, aw = np.abs(g - w), np.abs(w)
        assert (err <= 2.0 ** -7 * aw + 2.0 ** -8 * aw.max()).all(), (
            float(err.max()), float(aw.max()))
        assert err.mean() <= 2.0 ** -8 * aw.mean(), (float(err.mean()),
                                                     float(aw.mean()))


@pytest.mark.parametrize("b,s,t,hq,kh,hd,causal,win,off", [
    (1, 512, 512, 8, 2, 64, True, 0, 0), (1, 300, 400, 4, 1, 120, True, 96,
                                          100),
    (2, 129, 129, 4, 2, 32, False, 0, 0),
    (1, 300, 300, 4, 2, 256, True, 0, 0)])     # sums twice as long
def test_bf16_slack_covers_sums_in_another_order(b, s, t, hq, kh, hd,
                                                 causal, win, off):
    """The bf16 arithmetic taken in float64 (other sums, so P and dS meet
    their bf16 ties elsewhere) against float32 stays within 2e-5 of max
    |grad| plus `attention_bwd_bf16_slack` per element: the allowance the
    card's bf16 kernel gets for the same rounding flips against this plain
    version; at these widths flips occur, so without it the rule fails."""
    q, k, v, do = map(_bf16_valued, _qkv(s + t + hd, b, s, t, hq, kh, hd))
    pos = np.arange(off, off + s)
    o, lse = _plain_o_lse(q, k, v, pos, causal, win)
    o = o.to(torch.bfloat16).float()
    kw = {"q_pos": _t(pos), "causal": causal, "window": win}
    args32 = (*(_t(x) for x in (q, k, v)), o, _t(do), lse)
    r32 = attention_bwd_gqa_ref(*args32, **kw, plain=attention_bwd_bf16_ref)
    r64 = attention_bwd_gqa_ref(*(x.double() for x in args32), **kw,
                                plain=attention_bwd_bf16_ref)
    slack = attention_bwd_gqa_ref(*args32, **kw,
                                  plain=attention_bwd_bf16_slack)
    flips = 0
    for a, w, sl in zip(r32, r64, slack):
        err, top = (a.double() - w).abs(), float(w.abs().max())
        assert bool((err <= 2e-5 * top + sl.double()).all())
        flips += int((err > 2e-5 * top).sum())
    assert flips > 0


SPLIT_CASES = [  # b, s, t, hq, kh, hd, causal, window, q_pos offset, max |s|
    (1, 256, 256, 4, 2, 64, True, 0, 0, None),
    (1, 256, 256, 4, 2, 64, True, 128, 0, None),
    (1, 200, 200, 4, 1, 120, True, 128, 0, None),
    (1, 333, 333, 4, 2, 128, True, 0, 0, None),
    (1, 100, 300, 4, 2, 64, True, 128, 200, None),
    (2, 130, 130, 2, 2, 120, False, 0, 0, None),
    (1, 256, 256, 4, 2, 120, True, 0, 0, 30.0),
    (1, 200, 200, 4, 2, 128, True, 128, 0, 30.0),
    (1, 200, 200, 4, 2, 160, True, 128, 0, None),
    (1, 100, 256, 4, 2, 160, True, 0, 156, 30.0),
    (1, 256, 256, 4, 2, 256, True, 0, 0, None),
    (1, 130, 130, 2, 1, 256, False, 0, 0, None),
    (1, 256, 256, 4, 2, 256, True, 128, 0, 30.0)]


@pytest.mark.parametrize("b,s,t,hq,kh,hd,causal,win,off,s_max", SPLIT_CASES)
def test_split_tf32_backward_arithmetic_holds_the_f32_tolerance(
        b, s, t, hq, kh, hd, causal, win, off, s_max):
    """`attention_bwd_split_tf32` (the f32 backward kernels' arithmetic:
    each of the five products as three TF32 products of split operands)
    against `attention_bwd_ref` on the same o and lse and against
    `jax.grad` of the reference's `dense_attention`, at the f32 route's
    2e-5 of max |grad| per element: hd 64 / 120 / 128 and the wide
    kernels' 160 / 256 (sums twice as long), windows 0 and 128,
    ragged S, a q_pos offset, non-causal, and q and k scaled alike so that
    max |s| is `s_max`."""
    from repro_torch.kernels.flash_attention.ref import (
        attention_bwd_split_tf32,
    )
    q, k, v, do = _qkv(s + t + hd + win, b, s, t, hq, kh, hd)
    if s_max is not None:
        kr = np.repeat(k, hq // kh, axis=2)
        s0 = np.abs(np.einsum("bqhd,bkhd->bhqk", q, kr)).max() * hd ** -0.5
        c = np.float32(np.sqrt(s_max / s0))
        q, k = q * c, k * c
    pos = np.arange(off, off + s)
    o, lse = _plain_o_lse(q, k, v, pos, causal, win)
    args = (*(_t(x) for x in (q, k, v)), o, _t(do), lse)
    kw = {"q_pos": _t(pos), "causal": causal, "window": win}
    got = attention_bwd_gqa_ref(*args, **kw, plain=attention_bwd_split_tf32)
    _assert_grads_close(got, attention_bwd_gqa_ref(*args, **kw), 2e-5)

    def jloss(q_, k_, v_):
        out = jattn.dense_attention(q_, k_, v_, q_pos=jnp.asarray(pos),
                                    kv_pos=jnp.arange(t), causal=causal,
                                    window=win)
        return jnp.sum(out * jnp.asarray(do))
    want = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(
        *map(jnp.asarray, (q, k, v)))
    _assert_grads_close(got, want, 2e-5)


@pytest.mark.parametrize("causal,win,off", [(True, 0, 0), (True, 5, 3),
                                            (False, 0, 0), (False, 6, 0)])
def test_flash_attention_fn_gradcheck_in_float64(causal, win, off):
    """`FlashAttentionFn`'s CPU route (the plain forward with its lse and
    `attention_bwd_ref`) passes `torch.autograd.gradcheck` in float64."""
    q, k, v, _ = _qkv(7 + win, 1, 9, 9 + off, 4, 2, 4, np.float64)
    pos = torch.arange(off, off + 9)
    args = tuple(_t(x).requires_grad_() for x in (q, k, v))
    assert torch.autograd.gradcheck(
        lambda q_, k_, v_: FlashAttentionFn.apply(q_, k_, v_, pos, causal,
                                                  win), args)


@pytest.mark.parametrize("remat", [False, True])
def test_flash_branch_grads_match_jax(remat):
    """The model's flash branch (the CPU route's blocked online softmax,
    with and without `attn_remat`'s per-block checkpoint) at S = 2048:
    outputs and q / k / v gradients against `jax.grad` of the reference's
    `flash_attention`."""
    b, s, hq, kh, hd, win = 1, 2048, 4, 2, 8, 700
    q, k, v, do = _qkv(3, b, s, s, hq, kh, hd)
    pos = np.arange(s)

    def jloss(q_, k_, v_):
        out = jattn.flash_attention(q_, k_, v_, q_pos=jnp.asarray(pos),
                                    window=win, kv_chunk=512, remat=remat)
        return jnp.sum(out * jnp.asarray(do))
    want = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(
        *map(jnp.asarray, (q, k, v)))
    xs = [_t(x).requires_grad_() for x in (q, k, v)]
    out = tattn.flash_attention(*xs, q_pos=_t(pos), window=win,
                                kv_chunk=512, remat=remat)
    got = torch.autograd.grad(out, xs, _t(do))
    _assert_grads_close(got, want, 2e-5)


# --------------------------------------------------------- loss / train ----
def _cfgs(arch, s, **over):
    """The reference's reduced 2-layer config at d_model 32 (4 heads of 8)
    and vocab 128, and the port's equal one; `s` above 1024 takes the
    flash branch."""
    cfg = dataclasses.replace(
        jax_get_config(arch).reduced(n_layers=2, d_model=32), vocab=128,
        **over)
    return cfg, tconfig.ArchConfig(**dataclasses.asdict(cfg))


def _params(tcfg, seed):
    """Seeded params as numpy trees, for both sides (the port's draws: the
    reference's eager init takes ~10 s of op compiles on the CPU)."""
    return params_to_numpy(TM.init_params(
        tcfg, torch.Generator().manual_seed(seed), device="cpu"))


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


@pytest.mark.parametrize("s", [64, 2048])
@pytest.mark.parametrize("arch", ["tinyllama_1_1b", "h2o_danube_3_4b",
                                  "chatglm3_6b"])
def test_loss_and_grads_match_the_reference(arch, s):
    """`loss_fn` and its gradients (every param leaf, the stacked layer
    leaves included) against `jax.value_and_grad(loss_fn)`: TinyLlama,
    Danube with its window (64 in the reduced config), ChatGLM3 with its
    rope fraction 0.5; S = 64 takes the dense branch, S = 2048 the flash
    branch."""
    jcfg, tcfg = _cfgs(arch, s)
    params = jax.tree.map(jnp.asarray, _params(tcfg, 1))
    tokens = _tokens(2, 1, s, jcfg.vocab)
    loss, grads = jax.jit(jax.value_and_grad(partial(JM.loss_fn, jcfg)))(
        params, {"tokens": jnp.asarray(tokens)})
    leaves = [x.requires_grad_() for x in tree_leaves(params_from_numpy(
        _np(params)))]
    from repro_torch.tree import tree_unflatten
    tp = tree_unflatten(params_from_numpy(_np(params)), leaves)
    got = TM.loss_fn(tcfg, tp, {"tokens": _t(tokens).long()})
    tgrads = torch.autograd.grad(got, leaves)
    np.testing.assert_allclose(float(got.detach()), float(loss), rtol=1e-5)
    assert tree_paths(tp) == ["/".join(str(getattr(k, "key", k))
                                       for k in path) for path, _ in
                              jax.tree_util.tree_flatten_with_path(
                                  params)[0]]
    _assert_grads_close(tgrads, jax.tree.leaves(grads), 1e-4)


@pytest.mark.parametrize("optimizer", ["adamw", "sgd"])
def test_train_steps_match_the_reference(optimizer):
    """3 `train_step`s (the reference's learning rates and momentum) from
    the same params and optimizer state: losses at 1e-5 relative, params
    at 1e-6 (SGD), and for AdamW at 1e-5 but where a gradient is ~0 (see
    below), with its moments at 1e-5 of a leaf's max (2.1e-6 measured)."""
    jcfg, tcfg = _cfgs("tinyllama_1_1b", 64, optimizer=optimizer)
    params = jax.tree.map(jnp.asarray, _params(tcfg, 4))
    opt_init, step = JM.make_train_step(jcfg)
    step = jax.jit(step)
    opt = opt_init(params)
    tp, topt = params_from_numpy(_np(params)), params_from_numpy(_np(opt))
    _, tstep = TM.make_train_step(tcfg)
    for i in range(3):
        batch = _tokens(10 + i, 2, 64, jcfg.vocab)
        params, opt, m = step(params, opt, {"tokens": jnp.asarray(batch)})
        tp, topt, tm = tstep(tp, topt, {"tokens": _t(batch).long()})
        np.testing.assert_allclose(float(tm["loss"]), float(m["loss"]),
                                   rtol=1e-5)
    for a, b in zip(tree_leaves(tp), jax.tree.leaves(params)):
        err = np.abs(_f32(a) - _f32(b))
        if optimizer == "sgd":
            assert err.max() <= 1e-6
        else:
            # each AdamW step moves a param by lr * m_hat / (sqrt(v_hat) +
            # eps), which flips with the sign of a gradient that is ~0:
            # all but 1e-3 of them at 1e-5
            assert np.mean(err > 1e-5) <= 1e-3
    if optimizer == "adamw":
        assert int(topt.step) == 3 and topt.step.dtype == torch.int32
        # the gradients, through AdamW's moments, agree everywhere
        for a, b in zip(tree_leaves(topt.mu) + tree_leaves(topt.nu),
                        jax.tree.leaves((opt.mu, opt.nu))):
            assert np.abs(_f32(a) - _f32(b)).max() <= 1e-5 * np.abs(
                _f32(b)).max()
    # the module-level train_step is make_train_step's step
    p2, _, m2 = TM.train_step(tcfg, params_from_numpy(_np(params)),
                              params_from_numpy(_np(opt)),
                              {"tokens": _t(batch).long()})
    assert np.isfinite(float(m2["loss"]))


def test_remat_is_bitwise_the_plain_step():
    """At S = 2048 (the flash branch, one layer), `remat=True` (each layer
    checkpointed) and `attn_remat=True` (each flash block checkpointed)
    give bitwise the loss and new params of neither; the CPU never counts
    a kernel launch."""
    outs = []
    kernels.reset_launches()
    for remat in (False, True):
        _, tcfg = _cfgs("h2o_danube_3_4b", 2048, remat=remat,
                        attn_remat=remat, n_layers=1)
        params, opt, step, gen = launch_train.build_lm(tcfg, 5, "cpu")
        p, _, m = step(params, opt, launch_train.synth_batch(tcfg, gen, 1,
                                                             2048))
        outs.append((m["loss"], tree_leaves(p)))
    assert not any(kernels.LAUNCHES.values())
    assert torch.equal(outs[0][0], outs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(outs[0][1], outs[1][1]))


def test_serving_paths_keep_no_graph():
    """`forward` under grad builds a graph only when a param requires it;
    prefill and decode serve under no_grad."""
    _, tcfg = _cfgs("tinyllama_1_1b", 64)
    params = TM.init_params(tcfg, torch.Generator().manual_seed(0),
                            device="cpu")
    tokens = {"tokens": _t(_tokens(1, 1, 16, tcfg.vocab)).long()}
    assert not TM.forward(tcfg, params, tokens)[0].requires_grad
    p = dict(params, head={"w": params["head"]["w"].requires_grad_()})
    assert TM.forward(tcfg, p, tokens)[0].requires_grad
    cache, lg = TM.prefill_step(tcfg, p, tokens, cache_len=20)
    assert not lg.requires_grad and not cache["k"].requires_grad


# ------------------------------------------------------- entry points -----
def test_launch_train_lm_mode_prints_the_reference_lines(capsys):
    launch_train.main(["--mode", "lm", "--steps", "3", "--seq", "32",
                       "--layers", "2", "--d-model", "32", "--vocab", "64",
                       "--batch-size", "2", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "step,loss,tok_per_s"
    assert [ln.split(",")[0] for ln in lines[1:]] == ["0", "1", "2"]
    assert all(re.fullmatch(r"\d+,\d+\.\d{4},\d+", ln) for ln in lines[1:])


def test_launch_train_federated_mode_prints_the_reference_lines(capsys,
                                                                tmp_path):
    ck = str(tmp_path / "server.npz")
    launch_train.main(["--mode", "federated", "--rounds", "2", "--clients",
                       "6", "--n-train", "300", "--n-val", "60", "--n-test",
                       "60", "--epochs", "1", "--batches", "1",
                       "--batch-size", "8", "--device", "cpu",
                       "--checkpoint", ck])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "round,test_acc"
    assert all(re.fullmatch(r"\d+,\d\.\d{4}", ln) for ln in lines[1:3])
    assert re.fullmatch(r"# final=\d\.\d{4} shapley_evals=\d+ wall=\d+\.\ds",
                        lines[3])
    assert lines[4] == f"# checkpoint -> {ck}"
    from repro_torch.checkpoint.ckpt import load_server_state
    from repro_torch.models.mlp_cnn import make_mlp
    state = load_server_state(ck, make_mlp().init(
        torch.Generator().manual_seed(0), "cpu"))
    assert state["round"] == 2 and state["sv"].shape == (6,)


def test_federated_lm_example_prints_the_reference_lines(capsys):
    spec = importlib.util.spec_from_file_location(
        "federated_lm_torch", ROOT / "examples" / "federated_lm_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main(["--device", "cpu", "--rounds", "2", "--clients", "4",
              "--select", "2", "--local-steps", "1", "--seq", "32",
              "--batch", "2", "--d-model", "32", "--layers", "1"])
    lines = capsys.readouterr().out.splitlines()
    assert re.fullmatch(r"# federated LM: tinyllama-1\.1b-reduced \(\d+\.\dM "
                        r"params\), N=4 M=2 T=2", lines[0])
    assert lines[1] == "round,val_loss,selected"
    for ln in lines[2:4]:
        assert re.fullmatch(r"\d+,\d+\.\d{4},\[\d+, \d+\]", ln)
    assert lines[4].startswith("# wall ")
    assert lines[5].startswith("# client quality (true):   [")
    assert lines[6].startswith("# SV ranking (discovered): [")
    assert re.fullmatch(r"# top-half overlap between SV ranking and true "
                        r"quality: \d\.\d\d", lines[7])


def test_entry_points_train_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    _, tcfg = _cfgs("tinyllama_1_1b", 64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.build_lm(tcfg, 0, None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--mode", "lm", "--steps", "1", "--layers", "1"])


def test_the_port_imports_neither_jax_nor_the_reference():
    """No module of the port, nor its chip smoke test and examples,
    imports `jax` or anything of `repro`."""
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)",
                     re.M)
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py"] + sorted(
        (ROOT / "examples").glob("*_torch.py"))
    assert len(files) > 60
    bad = [str(f.relative_to(ROOT)) for f in files
           if pat.search(f.read_text())]
    assert bad == []
