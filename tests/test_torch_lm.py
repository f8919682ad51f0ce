"""The port's LM serving path against the reference's, on the CPU: configs,
layers, the flash_attention kernel's plain version, both attention paths,
forward / prefill / ring-cache decode, and `serve_requests`.

Every comparison feeds the same numpy-seeded inputs (and the reference's
own params, carried across with `params_from_numpy`) to the JAX function
and its port counterpart.  Tolerances: elementwise layers at 1e-6 (the
same float32 operations); attention at 2e-5 in float32 (sums in another
order) and 3e-2 in bf16 (the reference test's bound: one bf16 rounding of
outputs of magnitude ~1); model logits and caches at 1e-4 in float32 (two
layers of float32 products in another order; measured ~8e-6) and, in
bf16, at 0.1 absolute on values of magnitude ~4.5, about three bf16 steps
(0.03125 each between 4 and 8; measured 0.05), since bf16 activations
round each product's output at other places in XLA and in PyTorch;
serving at 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import TUNED_OVERRIDES as JAX_TUNED
from repro.configs import get_config as jax_get_config
from repro.core.aggregation import tree_stack as jax_tree_stack
from repro.core.shapley import exact_shapley as jax_exact_shapley
from repro.kernels.flash_attention.ops import flash_attention_tpu
from repro.kernels.flash_attention.ref import attention_ref as jax_attn_ref
from repro.models.lm import attention as jattn
from repro.models.lm import config as jconfig
from repro.models.lm import layers as jlayers
from repro.models.lm import model as JM
from repro_torch import kernels
from repro_torch.configs import ARCH_IDS, TUNED_OVERRIDES, get_config
from repro_torch.interop import params_from_numpy
from repro_torch.kernels.flash_attention import (
    attention_ref, flash_attention, flash_attention_gqa,
)
from repro_torch.models.lm import attention as tattn
from repro_torch.models.lm import config as tconfig
from repro_torch.models.lm import layers as tlayers
from repro_torch.models.lm import model as TM
from repro_torch.serve import request_shapley, serve_requests
from repro_torch.tree import tree_leaves, tree_paths

DENSE = ["h2o_danube_3_4b", "tinyllama_1_1b", "chatglm3_6b",
         "mistral_nemo_12b"]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


# ------------------------------------------------------------- configs ----
@pytest.mark.parametrize("arch", JAX_ARCH_IDS)
def test_configs_equal_field_by_field(arch):
    ref = jax_get_config(arch)
    got = get_config(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert (dataclasses.asdict(got.reduced())
            == dataclasses.asdict(ref.reduced()))
    assert (dataclasses.asdict(get_config(arch, tuned=True))
            == dataclasses.asdict(jax_get_config(arch, tuned=True)))
    for fn in ("param_count", "active_param_count"):
        assert getattr(tconfig, fn)(got) == getattr(jconfig, fn)(ref)
    assert got.hd == ref.hd and got.subquadratic == ref.subquadratic


def test_registry_matches():
    assert ARCH_IDS == JAX_ARCH_IDS and TUNED_OVERRIDES == JAX_TUNED
    assert get_config("h2o-danube-3-4b") == get_config("h2o_danube_3_4b")


# -------------------------------------------------------------- layers ----
def test_norms_match():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 48)).astype(np.float32) * 3 + 0.5
    scale = rng.standard_normal(48).astype(np.float32)
    for kind in ("rms", "layer"):
        want = jlayers.apply_norm(kind, {"scale": jnp.asarray(scale)},
                                  jnp.asarray(x))
        got = tlayers.apply_norm(kind, {"scale": _t(scale)}, _t(x))
        np.testing.assert_allclose(_f32(got), _f32(want), atol=1e-6,
                                   err_msg=kind)


@pytest.mark.parametrize("frac", [1.0, 0.5])
def test_rope_matches(frac):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 3, 40)).astype(np.float32)
    pos = np.array([0, 1, 5, 17, 300, 4095, 8191], np.int32)
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), frac=frac,
                              theta=1e4)
    got = tlayers.apply_rope(_t(x), _t(pos), frac=frac, theta=1e4)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=1e-6)
    np.testing.assert_array_equal(
        _f32(tlayers.rope_frequencies(40, frac, 1e4)),
        _f32(jlayers.rope_frequencies(40, frac, 1e4)))


@pytest.mark.parametrize("kind", ["swiglu", "gelu"])
def test_ffn_matches(kind):
    p = _np(jlayers.ffn_init(jax.random.key(3), 32, 64, kind))
    x = np.random.default_rng(2).standard_normal((2, 6, 32)).astype(
        np.float32)
    want = jlayers.ffn_apply(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                             kind)
    got = tlayers.ffn_apply(params_from_numpy(p), _t(x), kind)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=1e-6)


def test_embed_head_and_cross_entropy_match():
    rng = np.random.default_rng(4)
    table = rng.standard_normal((50, 16)).astype(np.float32)
    w = rng.standard_normal((16, 50)).astype(np.float32)
    tokens = rng.integers(0, 50, (2, 9)).astype(np.int32)
    for dt_j, dt_t in ((jnp.float32, torch.float32),
                       (jnp.bfloat16, torch.bfloat16)):
        e_j = jlayers.embed_apply({"table": jnp.asarray(table)},
                                  jnp.asarray(tokens), dt_j)
        e_t = tlayers.embed_apply({"table": _t(table)}, _t(tokens), dt_t)
        np.testing.assert_array_equal(_f32(e_t), _f32(e_j))
    x = rng.standard_normal((2, 9, 16)).astype(np.float32)
    lg_j = jlayers.head_apply({"w": jnp.asarray(w)}, jnp.asarray(x))
    lg_t = tlayers.head_apply({"w": _t(w)}, _t(x))
    assert lg_t.dtype == torch.float32
    np.testing.assert_allclose(_f32(lg_t), _f32(lg_j), atol=1e-5)
    mask = rng.random((2, 9)) > 0.3
    for m in (None, mask):
        want = jlayers.cross_entropy_tokens(
            lg_j, jnp.asarray(tokens), None if m is None else jnp.asarray(m))
        got = tlayers.cross_entropy_tokens(
            lg_t, _t(tokens), None if m is None else _t(m))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# ------------------------------------------------------ kernel (plain) ----
FLASH_SHAPES = [(2, 256, 4, 2, 64, 0), (1, 512, 8, 8, 32, 128),
                (2, 256, 6, 2, 64, 64), (1, 256, 2, 1, 128, 0),
                (1, 256, 4, 2, 120, 64)]


def _qkv(seed, b, s, hq, kh, hd, t=None):
    rng = np.random.default_rng(seed)
    t = s if t is None else t
    return (rng.standard_normal((b, s, hq, hd)).astype(np.float32),
            rng.standard_normal((b, t, kh, hd)).astype(np.float32),
            rng.standard_normal((b, t, kh, hd)).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,hq,kh,hd,win", FLASH_SHAPES)
def test_flash_plain_matches_reference_kernel_and_ref(b, s, hq, kh, hd, win,
                                                      dtype):
    q, k, v = _qkv(s + hd + win, b, s, hq, kh, hd)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    qj, kj, vj = (jnp.asarray(a).astype(jdt) for a in (q, k, v))
    qt, kt, vt = (_t(a).to(tdt) for a in (q, k, v))
    atol = 3e-2 if dtype == "bfloat16" else 2e-5
    before = dict(kernels.LAUNCHES)
    got = flash_attention_gqa(qt, kt, vt, window=win)
    assert kernels.LAUNCHES == before        # the CPU never counts a launch
    assert got.dtype == tdt and got.shape == (b, s, hq, hd)
    want_kernel = flash_attention_tpu(qj, kj, vj, causal=True, window=win,
                                      block_q=128, block_k=128,
                                      interpret=True)
    np.testing.assert_allclose(_f32(got), _f32(want_kernel), atol=atol)
    # the (BH, S, hd) contract against the reference's ref, on one group
    g = hq // kh
    qf = qj.reshape(b, s, kh, g, hd).transpose(0, 2, 3, 1, 4).reshape(-1, s,
                                                                       hd)
    kf = jnp.repeat(kj.transpose(0, 2, 1, 3), g, axis=1).reshape(-1, s, hd)
    vf = jnp.repeat(vj.transpose(0, 2, 1, 3), g, axis=1).reshape(-1, s, hd)
    want_ref = jax_attn_ref(qf, kf, vf, causal=True, window=win)
    got_ref = flash_attention(_t(np.asarray(qf.astype(jnp.float32))).to(tdt),
                              _t(np.asarray(kf.astype(jnp.float32))).to(tdt),
                              _t(np.asarray(vf.astype(jnp.float32))).to(tdt),
                              causal=True, window=win)
    np.testing.assert_allclose(_f32(got_ref), _f32(want_ref), atol=atol)


@pytest.mark.parametrize("s,hd,win,s_max", [
    (256, 64, 0, None), (256, 64, 128, None), (256, 120, 0, None),
    (256, 120, 128, None), (256, 128, 0, None), (256, 128, 128, None),
    (200, 120, 128, None), (333, 64, 0, None), (256, 120, 0, 30.0),
    (200, 128, 128, 30.0)])
def test_split_tf32_arithmetic_holds_the_f32_tolerance(s, hd, win, s_max):
    """The f32 CUDA route's split-TF32 arithmetic (`attention_split_tf32`,
    three TF32 products a product) against the reference's Pallas kernel
    (interpret mode; its plain ref where S is not a multiple of the block)
    and its attention_ref, at the f32 route's 2e-5: hd 64/120/128, windows
    0 and 128, ragged S, and inputs scaled so that max |s| is `s_max`."""
    from repro_torch.kernels.flash_attention.ref import attention_split_tf32
    b, hq, kh = 1, 4, 2
    q, k, v = _qkv(s + hd + win, b, s, hq, kh, hd)
    if s_max is not None:      # q and k scaled alike: max |s| = s_max
        g = hq // kh
        kr = np.repeat(k, g, axis=2)
        s0 = np.abs(np.einsum("bqhd,bkhd->bhqk", q, kr)).max() * hd ** -0.5
        c = np.float32(np.sqrt(s_max / s0))
        q, k = q * c, k * c
    qj, kj, vj = (jnp.asarray(a) for a in (q, k, v))
    g = hq // kh
    fold = lambda x: x.reshape(b, s, kh, g, hd).transpose(0, 2, 3, 1, 4
                                                          ).reshape(-1, s, hd)
    qf = fold(q)
    kf = np.repeat(k.transpose(0, 2, 1, 3), g, axis=1).reshape(-1, s, hd)
    vf = np.repeat(v.transpose(0, 2, 1, 3), g, axis=1).reshape(-1, s, hd)
    got = _f32(attention_split_tf32(_t(qf), _t(kf), _t(vf), window=win))
    want_kernel = fold(_f32(flash_attention_tpu(
        qj, kj, vj, causal=True, window=win, block_q=128, block_k=128,
        interpret=True)))
    want_ref = _f32(jax_attn_ref(jnp.asarray(qf), jnp.asarray(kf),
                                 jnp.asarray(vf), causal=True, window=win))
    np.testing.assert_allclose(got, want_kernel, atol=2e-5, rtol=0)
    np.testing.assert_allclose(got, want_ref, atol=2e-5, rtol=0)


def test_flash_plain_with_query_positions_and_non_causal():
    q, k, v = _qkv(7, 1, 40, 2, 2, 16)
    pos = np.arange(20, 60)
    for causal, win in ((True, 0), (True, 16), (False, 0), (False, 16)):
        want = jattn.dense_attention(
            *(jnp.asarray(a) for a in (q, k, v)), q_pos=jnp.asarray(pos),
            kv_pos=jnp.arange(40), causal=causal, window=win)
        got = flash_attention_gqa(*(_t(a) for a in (q, k, v)),
                                  q_pos=_t(pos), causal=causal, window=win)
        np.testing.assert_allclose(_f32(got), _f32(want), atol=2e-5)
        got_bh = attention_ref(_t(q[0].transpose(1, 0, 2)),
                               _t(k[0].transpose(1, 0, 2)),
                               _t(v[0].transpose(1, 0, 2)), causal=causal,
                               window=win, q_pos=_t(pos))
        np.testing.assert_allclose(_f32(got_bh).transpose(1, 0, 2),
                                   _f32(want)[0], atol=2e-5)


def _bf16(*shape):
    return torch.randn(shape).to(torch.bfloat16)


@pytest.mark.parametrize("make,ready", [
    (lambda: _bf16(2, 64, 4, 120), True),
    (lambda: _bf16(2, 64, 4, 121)[..., :120], False),    # 242-byte rows
    (lambda: _bf16(2, 64, 4, 121)[..., 1:], False),      # base + 2 bytes
    (lambda: _bf16(2, 64, 4, 128)[..., :120], True),     # 256-byte rows
    (lambda: _bf16(2, 64, 4, 33), False),
    (lambda: _bf16(64, 120)[None, :, None], True),  # size-1 dims: not stepped
    (lambda: _bf16(2, 4, 64, 120).transpose(1, 2), True),
    (lambda: _bf16(2, 64, 1, 120).expand(2, 64, 4, 120), False)])  # stride 0
def test_tma_ready_and_copy(make, ready):
    """Which bf16 views the tensor-core route reads in place (16-byte
    aligned base, stepped strides positive multiples of 16 bytes), and the
    padded copy the wrapper makes of the others."""
    from repro_torch.kernels.flash_attention.kernel import tma_copy, tma_ready
    x = make()
    assert tma_ready(x) is ready
    c = tma_copy(x)
    assert tma_ready(c) and c.shape == x.shape and torch.equal(c, x)
    assert c.stride(-1) == 1 and c.stride(2) % 8 == 0


# ---------------------------------------------------- attention paths -----
@pytest.mark.parametrize("b,s,hq,kh,hd,win,chunk", [
    (2, 128, 4, 2, 16, 0, 32), (1, 128, 4, 1, 24, 40, 32),
    (2, 96, 2, 2, 8, 32, 32), (1, 64, 6, 3, 12, 16, 16)])
def test_chunked_flash_and_dense_match_reference(b, s, hq, kh, hd, win,
                                                 chunk):
    q, k, v = _qkv(s * hd + win, b, s, hq, kh, hd)
    pos = np.arange(s)
    jargs = [jnp.asarray(a) for a in (q, k, v)]
    targs = [_t(a) for a in (q, k, v)]
    want = jattn.flash_attention(*jargs, q_pos=jnp.asarray(pos),
                                 window=win, kv_chunk=chunk)
    got = tattn.flash_attention(*targs, q_pos=_t(pos), window=win,
                                kv_chunk=chunk, remat=True)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=2e-5)
    valid = np.arange(s) % 5 != 3
    want_d = jattn.dense_attention(*jargs, q_pos=jnp.asarray(pos),
                                   kv_pos=jnp.asarray(pos), window=win,
                                   kv_valid=jnp.asarray(valid))
    got_d = tattn.dense_attention(*targs, q_pos=_t(pos), kv_pos=_t(pos),
                                  window=win, kv_valid=_t(valid))
    np.testing.assert_allclose(_f32(got_d), _f32(want_d), atol=2e-5)


@pytest.mark.parametrize("s,win", [(1536, 0), (1536, 512), (1000, 256)])
def test_attention_dispatch_matches_reference(s, win):
    """impl="auto": flash above 1024 rows with T % kv_chunk == 0, else
    dense, on both sides."""
    q, k, v = _qkv(s + win, 1, s, 2, 1, 8)
    pos = np.arange(s)
    want = jattn.attention(*(jnp.asarray(a) for a in (q, k, v)),
                           q_pos=jnp.asarray(pos), window=win)
    got = tattn.attention(*(_t(a) for a in (q, k, v)), q_pos=_t(pos),
                          window=win)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=2e-5)


# -------------------------------------------------------------- model -----
def _cfg(arch, dtype="float32"):
    """The reference's reduced 2-layer config and the port's equal one."""
    cfg = jax_get_config(arch).reduced(n_layers=2)
    if arch == "h2o_danube_3_4b":
        # flash branch at S = 128 with the reduced 64-slot window ring
        cfg = dataclasses.replace(cfg, attn_impl="flash", attn_chunk=32)
    cfg = dataclasses.replace(cfg, dtype=dtype)
    return cfg, tconfig.ArchConfig(**dataclasses.asdict(cfg))


@pytest.fixture(scope="module")
def model_runs():
    """The reference's forward, prefill and three decode steps for each
    case, computed once: S = 128 prompt, cache room for 8 more."""
    out = {}
    for arch in DENSE:
        for dtype in ("float32", "bfloat16"):
            jcfg, tcfg = _cfg(arch, dtype)
            params = JM.init_params(jcfg, jax.random.key(11))
            tokens = np.random.default_rng(5).integers(
                0, jcfg.vocab, (2, 131)).astype(np.int32)
            fwd, _ = JM.forward(jcfg, params, {"tokens": jnp.asarray(
                tokens[:, :128])})
            cache, lg = JM.prefill_step(jcfg, params, {"tokens": jnp.asarray(
                tokens[:, :128])}, cache_len=136)
            steps = [(_np({"k": cache["k"], "v": cache["v"]}), _f32(lg))]
            for i in range(3):
                cache, lg = JM.decode_step(jcfg, params, cache, {
                    "token": jnp.asarray(tokens[:, 128 + i])})
                steps.append((None, _f32(lg)))
            out[arch, dtype] = (tcfg, _np(params), tokens, _f32(fwd), steps,
                                np.asarray(cache["k"]))
    return out


def _model_atol(dtype):
    return 1e-4 if dtype == "float32" else 0.1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DENSE)
def test_forward_prefill_decode_match_reference(model_runs, arch, dtype):
    tcfg, params, tokens, fwd, steps, last_k = model_runs[arch, dtype]
    p = params_from_numpy(params)
    atol = _model_atol(dtype)
    got, aux = TM.forward(tcfg, p, {"tokens": _t(tokens[:, :128])})
    assert got.dtype == torch.float32 and float(aux) == 0.0
    np.testing.assert_allclose(_f32(got), fwd, atol=atol, rtol=0)
    cache, lg = TM.prefill_step(tcfg, p, {"tokens": _t(tokens[:, :128])},
                                cache_len=136)
    assert cache["pos"] == 128
    assert cache["k"].shape == steps[0][0]["k"].shape
    for name in ("k", "v"):
        np.testing.assert_allclose(_f32(cache[name]), steps[0][0][name],
                                   atol=atol, err_msg=name)
    np.testing.assert_allclose(_f32(lg), steps[0][1], atol=atol)
    for i in range(3):
        cache, lg = TM.decode_step(tcfg, p, cache,
                                   {"token": _t(tokens[:, 128 + i])})
        np.testing.assert_allclose(_f32(lg), steps[i + 1][1], atol=atol,
                                   err_msg=f"decode step {i}")
    assert cache["pos"] == 131
    np.testing.assert_allclose(_f32(cache["k"]), _f32(last_k), atol=atol)


def test_decode_matches_forward_at_the_same_position(model_runs):
    """The port's own decode logits equal its forward's, as the
    reference's test_decode_matches_forward holds (atol 2e-3)."""
    tcfg, params, tokens, _, _, _ = model_runs["h2o_danube_3_4b", "float32"]
    p = params_from_numpy(params)
    cache, lg = TM.prefill_step(tcfg, p, {"tokens": _t(tokens[:, :128])},
                                cache_len=136)
    # forward at S = 129, 130 takes the dense branch: the flash branch, on
    # both sides, assumes T % attn_chunk == 0
    dense = dataclasses.replace(tcfg, attn_impl="dense")
    for i in range(3):
        full, _ = TM.forward(dense, p, {"tokens": _t(tokens[:, :128 + i])})
        np.testing.assert_allclose(_f32(lg), _f32(full[:, -1]), atol=2e-3,
                                   rtol=2e-3, err_msg=f"decode step {i}")
        cache, lg = TM.decode_step(tcfg, p, cache,
                                   {"token": _t(tokens[:, 128 + i])})


def test_params_carry_across_and_init_matches_the_reference_tree():
    """`params_from_numpy(jax.tree.map(np.asarray, M.init_params(...)))`
    gives the port's tree with equal keys, shapes and values; the port's
    own `init_params` makes the same keys and shapes."""
    jcfg, tcfg = _cfg("h2o_danube_3_4b")
    ref = _np(JM.init_params(jcfg, jax.random.key(2)))
    got = params_from_numpy(ref)
    assert tree_paths(got) == tree_paths(ref)
    for a, b in zip(tree_leaves(got), tree_leaves(ref)):
        assert tuple(a.shape) == b.shape and a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), b)
    own = TM.init_params(tcfg, torch.Generator().manual_seed(0),
                         device="cpu")
    assert tree_paths(own) == tree_paths(ref)
    assert [tuple(a.shape) for a in tree_leaves(own)] == [
        b.shape for b in tree_leaves(ref)]
    # the draws' scales follow the reference's initialisers
    w = own["layers"]["ffn"]["w_down"]
    np.testing.assert_allclose(float(w.std()), (1 / tcfg.d_ff) ** 0.5,
                               rtol=0.05)
    np.testing.assert_allclose(float(own["embed"]["table"].std()), 0.02,
                               rtol=0.05)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    cfg = get_config("tinyllama_1_1b").reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TM.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_requests(cfg, {}, torch.zeros((1, 4), dtype=torch.int64), 1)


# ------------------------------------------------------------- serving ----
def _jax_serve(cfg, params, tokens, gen_len):
    """The loop of examples/serve_shapley.py, in JAX."""
    cache, logits = JM.prefill_step(cfg, params, {"tokens": tokens},
                                    cache_len=tokens.shape[1] + gen_len)
    out, lp_sum = [], jnp.zeros((tokens.shape[0],))
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    for _ in range(gen_len):
        out.append(tok)
        cache, logits = JM.decode_step(cfg, params, cache, {"token": tok})
        lp = jax.nn.log_softmax(logits, -1)
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        lp_sum += jnp.take_along_axis(lp, tok[:, None], 1)[:, 0]
    b = tokens.shape[0]
    stacked = jax_tree_stack([{"lp": lp_sum[r][None]} for r in range(b)])
    sv = jax_exact_shapley(stacked, jnp.ones(b), {"lp": jnp.zeros(1)},
                           lambda p: jnp.sum(p["lp"]))
    return np.asarray(jnp.stack(out, 1)), np.asarray(lp_sum), np.asarray(sv)


@pytest.mark.parametrize("arch,s,gen_len", [("h2o_danube_3_4b", 128, 6),
                                            ("tinyllama_1_1b", 40, 5),
                                            ("chatglm3_6b", 40, 5),
                                            ("mistral_nemo_12b", 40, 5)])
def test_serve_requests_matches_the_reference_loop(arch, s, gen_len):
    jcfg, tcfg = _cfg(arch)
    params = JM.init_params(jcfg, jax.random.key(7))
    tokens = np.random.default_rng(9).integers(0, jcfg.vocab,
                                               (4, s)).astype(np.int32)
    gen, lp, sv = _jax_serve(jcfg, params, jnp.asarray(tokens), gen_len)
    res = serve_requests(tcfg, params_from_numpy(_np(params)), _t(tokens),
                         gen_len, device="cpu")
    np.testing.assert_array_equal(res.generated.numpy(), gen)
    np.testing.assert_allclose(res.logprob_sum.numpy(), lp, atol=1e-4)
    np.testing.assert_allclose(res.sv.numpy(), sv, atol=1e-4)
    # efficiency: the SVs sum to the grand coalition's utility
    np.testing.assert_allclose(float(res.sv.sum()),
                               float(res.logprob_sum.mean()), atol=1e-4)
    assert res.prefill_s > 0 and res.decode_s > 0 and res.tokens_per_s > 0


def test_request_shapley_is_symmetric_and_efficient():
    lp = torch.tensor([-3.0, -1.0, -2.0, -1.0])
    sv = request_shapley(lp)
    np.testing.assert_allclose(float(sv.sum()), float(lp.mean()), atol=1e-6)
    assert abs(float(sv[1] - sv[3])) < 1e-7
