"""The port's MoE, SSM, hybrid, encoder-decoder and vision-stub LM families
against the reference's, on the CPU: the SSD layer, the MoE dispatch,
every non-dense arch's forward / prefill / decode, `loss_fn` and its
gradients, a train step, the init trees, `serve_requests` and the
launcher's frontend inputs.

Reference and port get the same numpy inputs from fixed seeds; params are
the port's seeded draws carried across with `repro_torch.interop` (the
reference's eager init takes seconds of op compiles a config).
Tolerances: the SSD layer and its decode step at 1e-5 in float32 (sums in
another order), the chunked path against its own sequential oracle at
1e-4 (as the reference's test); the MoE in float32 at 1e-5 (outputs), 1e-6
(aux) and its routing tables bitwise; model logits and caches at 1e-4 in
float32 and 0.1 in bf16 (`tests/test_torch_lm.py::_model_atol`: about
three bf16 steps at logits of ~4.5); `loss_fn` at 1e-5 relative and its
gradients at 1e-4 of each leaf's largest (as
`tests/test_torch_lm_train.py`).

In bf16 a token whose top-k experts are nearly tied may route differently
on the two sides: at equal inputs only where its k-th and (k+1)-th
probabilities lie within one bf16 ulp; inside the model, where the MoE's
inputs already differ by bf16 roundings, wherever that difference crosses
its gap, and a changed assignment moves the capacity ranks of the later
tokens of its experts.  Such tokens are found by routing both sides'
recorded MoE inputs and printed; the bf16 comparison leaves them out, and
with a reroute below the last layer every later token of its row, which
the attention above it reaches.
"""
import contextlib
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import get_config as jax_get_config
from repro.core.aggregation import tree_stack as jax_tree_stack
from repro.core.shapley import exact_shapley as jax_exact_shapley
from repro.models.lm import layers as jlayers
from repro.models.lm import model as JM
from repro.models.lm import moe as JMoE
from repro.models.lm import ssm as JSSM
from repro_torch.interop import params_from_numpy, params_to_numpy
from repro_torch.launch import train as launch_train
from repro_torch.models.lm import config as tconfig
from repro_torch.models.lm import layers as tlayers
from repro_torch.models.lm import model as TM
from repro_torch.models.lm import moe as TMoE
from repro_torch.models.lm import ssm as TSSM
from repro_torch.serve import serve_requests
from repro_torch.tree import tree_leaves, tree_paths, tree_unflatten

FAMILIES = ["mamba2_370m", "kimi_k2_1t_a32b", "qwen3_moe_30b_a3b",
            "internvl2_76b", "hymba_1_5b", "whisper_medium"]
MOE = ("kimi_k2_1t_a32b", "qwen3_moe_30b_a3b")
S = 128                     # prompt; 3 decode steps, cache room for 8


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


def _jnp(tree):
    return jax.tree.map(jnp.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _cfgs(arch, dtype="float32", reduce=None, **over):
    """The reference's reduced config (2 layers unless `reduce` says
    otherwise) and the port's equal one."""
    cfg = dataclasses.replace(jax_get_config(arch).reduced(
        **(reduce or {"n_layers": 2})), dtype=dtype, **over)
    return cfg, tconfig.ArchConfig(**dataclasses.asdict(cfg))


def _params(tcfg, seed):
    """Seeded params as a numpy tree, for both sides."""
    return params_to_numpy(TM.init_params(
        tcfg, torch.Generator().manual_seed(seed), device="cpu"))


def _batch(cfg, seed, b, s):
    """Tokens (B, S) and the frontend stub's input, numpy."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.frontend == "vision":
        batch["patches"] = rng.standard_normal(
            (b, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
    if cfg.frontend == "audio":
        batch["frames"] = rng.standard_normal(
            (b, max(cfg.n_frontend_tokens, 8), cfg.d_model)).astype(
                np.float32)
    return batch


def _tb(batch):
    return {k: _t(v) for k, v in batch.items()}


# ----------------------------------------------------------------- SSM ----
@pytest.mark.parametrize("arch,chunk,s", [("mamba2_370m", 64, 128),
                                          ("hymba_1_5b", 8, 32)])
def test_ssm_layer_and_decode_match_reference(arch, chunk, s):
    """`ssm_forward` (chunked SSD); the state after its last chunk and its
    conv windows, against the reference's closed-form `_ssm_final_state`;
    and 4 `ssm_decode_step`s from that state: against the reference at 1e-5
    in float32."""
    jcfg, tcfg = _cfgs(arch, ssm_chunk=chunk)
    p = params_to_numpy(TSSM.ssm_init(torch.Generator().manual_seed(1), tcfg))
    jp, tp = _jnp(p), params_from_numpy(p)
    x = np.random.default_rng(2).standard_normal(
        (2, s + 4, jcfg.d_model)).astype(np.float32)
    want = jax.jit(partial(JSSM.ssm_forward, cfg=jcfg))(
        jp, x=jnp.asarray(x[:, :s]))
    got, got_st = TSSM.ssm_forward(tp, tcfg, _t(x[:, :s]), with_state=True)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=1e-5, rtol=0)
    assert torch.equal(TSSM.ssm_forward(tp, tcfg, _t(x[:, :s])), got)
    want_st = jax.jit(partial(JM._ssm_final_state, cfg=jcfg))(
        jp, x=jnp.asarray(x[:, :s]))
    for name, g, w in zip(("state", "conv_x", "conv_bc"), got_st, want_st):
        np.testing.assert_allclose(_f32(g), _f32(w), atol=1e-5, rtol=0,
                                   err_msg=name)
    jc = dict(zip(("state", "conv_x", "conv_bc"), want_st))
    tc = dict(zip(("state", "conv_x", "conv_bc"), got_st))
    dec = jax.jit(partial(JSSM.ssm_decode_step, cfg=jcfg))
    for i in range(4):
        wy, jc = dec(jp, x=jnp.asarray(x[:, s + i]), cache=jc)
        gy, tc = TSSM.ssm_decode_step(tp, tcfg, _t(x[:, s + i]), tc)
        np.testing.assert_allclose(_f32(gy), _f32(wy), atol=1e-5, rtol=0,
                                   err_msg=f"decode step {i}")
        for k in jc:
            np.testing.assert_allclose(_f32(tc[k]), _f32(jc[k]), atol=1e-5,
                                       rtol=0, err_msg=f"{k} at step {i}")


def test_ssd_chunked_matches_its_sequential_oracle():
    """The port's chunked SSD against its own `ssm_forward_ref` (one decode
    step a token) at 1e-4, as the reference's test holds its own; and the
    reference's oracle against the port's at 1e-5."""
    jcfg, tcfg = _cfgs("mamba2_370m", ssm_chunk=8)
    p = params_to_numpy(TSSM.ssm_init(torch.Generator().manual_seed(3), tcfg))
    x = np.random.default_rng(4).standard_normal(
        (2, 32, jcfg.d_model)).astype(np.float32)
    tp = params_from_numpy(p)
    seq = TSSM.ssm_forward_ref(tp, tcfg, _t(x))
    np.testing.assert_allclose(_f32(TSSM.ssm_forward(tp, tcfg, _t(x))),
                               _f32(seq), atol=1e-4, rtol=0)
    want = JSSM.ssm_forward_ref(_jnp(p), jcfg, jnp.asarray(x))
    np.testing.assert_allclose(_f32(seq), _f32(want), atol=1e-5, rtol=0)


def test_ssd_gradient_is_finite_where_the_masked_exponent_overflows():
    """With large steps (dt ~ 3, A down to -16) the intra-chunk exponent
    above the diagonal passes float32's range: the reference's gradient
    (where(tri, exp(li), 0)) is NaN there; the port's, with the mask inside
    the exp, equals the gradient of its sequential oracle (no such
    exponent) at 1e-4 of each leaf's largest, and the outputs still agree
    with the reference's at 1e-5."""
    jcfg, tcfg = _cfgs("mamba2_370m", ssm_chunk=16)
    p = params_to_numpy(TSSM.ssm_init(torch.Generator().manual_seed(6), tcfg))
    p["dt_bias"][:] = 3.0
    x = np.random.default_rng(7).standard_normal(
        (1, 32, jcfg.d_model)).astype(np.float32)
    want, jgrad = jax.jit(jax.value_and_grad(
        lambda q: jnp.sum(JSSM.ssm_forward(q, jcfg, jnp.asarray(x)) ** 2)
    ))(_jnp(p))
    assert any(np.isnan(np.asarray(g)).any() for g in jax.tree.leaves(jgrad))
    grads = []
    for fn in (TSSM.ssm_forward, TSSM.ssm_forward_ref):
        tp = params_from_numpy(p)
        leaves = [t.requires_grad_() for t in tree_leaves(tp)]
        loss = torch.sum(fn(tree_unflatten(tp, leaves), tcfg, _t(x)) ** 2)
        grads.append((loss, torch.autograd.grad(loss, leaves)))
    (loss, got), (_, seq) = grads
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    assert all(bool(torch.isfinite(g).all()) for g in got)
    _leaves_close(got, seq, 1e-4)


def test_ssd_chunk_must_divide_the_sequence():
    _, tcfg = _cfgs("mamba2_370m")
    p = TSSM.ssm_init(torch.Generator().manual_seed(0), tcfg)
    with pytest.raises(AssertionError, match="not divisible"):
        TSSM.ssm_forward(p, tcfg, torch.zeros((1, 96, tcfg.d_model)))


# ----------------------------------------------------------------- MoE ----
def _ref_moe(p, jcfg, x, n_groups):
    """The reference's `moe_apply` and its (G, E, C) routing tables, read
    off the experts' input that it hands its `constrain` hook: a kept
    (expert, slot) holds its token's row (found by exact match; the rows
    are distinct draws), any other holds zeros and table id 0."""
    seen = {}

    def hook(t, dims):
        if len(dims) == 4:          # under jit: read back when it runs
            jax.debug.callback(
                lambda a: seen.__setitem__("expert_in", np.asarray(a)), t)
        return t

    y, aux = jax.jit(lambda q, a: JMoE.moe_apply(
        q, jcfg, a, n_groups=n_groups, constrain=hook))(_jnp(p),
                                                        jnp.asarray(x))
    jax.effects_barrier()
    ein = seen["expert_in"]
    xg = np.asarray(jnp.asarray(x)).reshape(n_groups, -1, x.shape[-1])
    valid = np.any(ein != 0, axis=-1)
    table = np.zeros(valid.shape, np.int32)
    for g in range(n_groups):
        rows = {xg[g, t].tobytes(): t for t in range(xg.shape[1])}
        for e, c in zip(*np.nonzero(valid[g])):
            table[g, e, c] = rows[ein[g, e, c].tobytes()]
    return y, aux, table, valid.astype(np.float32)


def _moe_case(arch, dtype, seed, b, s, **over):
    jcfg, tcfg = _cfgs(arch, dtype, **over)
    p = params_to_numpy(TMoE.moe_init(torch.Generator().manual_seed(seed),
                                      tcfg))
    x = np.random.default_rng(seed + 1).standard_normal(
        (b, s, jcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, p, x


@pytest.mark.parametrize("n_groups", [1, 2])
@pytest.mark.parametrize("cf", [8.0, 0.25])
def test_moe_matches_reference_in_f32(cf, n_groups):
    """`moe_apply` at capacity factors 8 (nothing dropped) and 0.25 (most
    assignments dropped), in one and two groups: the (table, valid)
    routing tables bitwise the reference's, outputs at 1e-5, aux at 1e-6;
    at 8.0 both equal the dense oracles too."""
    jcfg, tcfg, p, x = _moe_case("qwen3_moe_30b_a3b", "float32", 5, 2, 32,
                                 capacity_factor=cf)
    assert all(TMoE._capacity(tcfg, n) == JMoE._capacity(jcfg, n)
               for n in (1, 7, 32, 64, 513, 16384))
    y, aux, table, valid = _ref_moe(p, jcfg, x, n_groups)
    tp = params_from_numpy(p)
    xt = _t(x)
    got_table, got_valid, *_ = TMoE.moe_route(
        tp, tcfg, xt.reshape(n_groups, -1, x.shape[-1]))
    assert np.array_equal(got_table.numpy(), table)
    assert np.array_equal(got_valid.numpy(), valid)
    if cf == 0.25:
        # drops happen: fewer kept slots than assignments
        assert valid.sum() < x.shape[0] * x.shape[1] * jcfg.top_k / 2
    gy, gaux = TMoE.moe_apply(tp, tcfg, xt, n_groups=n_groups)
    np.testing.assert_allclose(_f32(gy), _f32(y), atol=1e-5, rtol=0)
    np.testing.assert_allclose(float(gaux), float(aux), atol=1e-6, rtol=0)
    if cf == 8.0:
        want = jax.jit(lambda q, a: JMoE.moe_apply_ref(q, jcfg, a))(
            _jnp(p), jnp.asarray(x))
        np.testing.assert_allclose(_f32(TMoE.moe_apply_ref(tp, tcfg, xt)),
                                   _f32(want), atol=1e-5, rtol=0)
        np.testing.assert_allclose(_f32(gy), _f32(want), atol=1e-5, rtol=0)


def test_moe_tied_router_logits_pick_the_reference_experts():
    """Three identical router columns: every token's probabilities tie
    across experts 0-2, and top-2 must take the lower indices, as
    `jax.lax.top_k` does (with expert 3 first or last)."""
    jcfg, tcfg, p, x = _moe_case("qwen3_moe_30b_a3b", "float32", 7, 2, 32,
                                 capacity_factor=8.0)
    p["router"][:, 1] = p["router"][:, 0]
    p["router"][:, 2] = p["router"][:, 0]
    y, aux, table, valid = _ref_moe(p, jcfg, x, 1)
    tp = params_from_numpy(p)
    got_table, got_valid, *_ = TMoE.moe_route(
        tp, tcfg, _t(x).reshape(1, -1, x.shape[-1]))
    assert np.array_equal(got_table.numpy(), table)
    assert np.array_equal(got_valid.numpy(), valid)
    # both orders occur: expert 3 in the top-2 (with 0) and out (0 and 1)
    assert valid[0, 3].any() and valid[0, 1].any() and not valid[0, 2].any()
    gy, gaux = TMoE.moe_apply(tp, tcfg, _t(x))
    np.testing.assert_allclose(_f32(gy), _f32(y), atol=1e-5, rtol=0)
    np.testing.assert_allclose(float(gaux), float(aux), atol=1e-6, rtol=0)


def _kept(tcfg, router, x):
    """Each token's kept experts, sorted, -1 for a dropped assignment:
    (T, top_k) int64 from the port's routing of x (B, S, D)."""
    g = tcfg.moe_groups
    _, _, _, flat_e, slot, _ = TMoE.moe_route(
        {"router": router}, tcfg, x.reshape(g, -1, x.shape[-1]))
    cap = TMoE._capacity(tcfg, x.shape[0] * x.shape[1] // g)
    e = torch.where(slot < cap, flat_e, -1).reshape(-1, tcfg.top_k)
    return e.sort(-1).values


def _bf16_ulp(p):
    return 2.0 ** (np.floor(np.log2(p)) - 7)


def test_moe_bf16_reroutes_only_near_ties():
    """bf16 on both sides from the same inputs (16 experts, top-2, no
    drops): a token routes differently only where the reference's k-th
    and (k+1)-th probabilities lie within one bf16 ulp (the count is
    printed); every other token's output at the dense bf16 tolerance."""
    jcfg, tcfg, p, x = _moe_case(
        "qwen3_moe_30b_a3b", "bfloat16", 9, 4, 64, capacity_factor=8.0,
        reduce={"n_layers": 2, "max_experts": 16})
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    y = jax.jit(lambda q, a: JMoE.moe_apply(q, jcfg, a))(_jnp(p), xb)[0]
    xt = _t(x).to(torch.bfloat16)
    tp = params_from_numpy(p)
    gy, _ = TMoE.moe_apply(tp, tcfg, xt)
    # the reference's routing, from its own router arithmetic
    logits = (xb.reshape(-1, jcfg.d_model)
              @ jnp.asarray(p["router"]).astype(jnp.bfloat16)).astype(
                  jnp.float32)
    probs = np.asarray(jax.nn.softmax(logits, axis=-1))
    top = np.sort(np.asarray(jax.lax.top_k(jnp.asarray(probs),
                                           jcfg.top_k)[1]), -1)
    got = _kept(tcfg, tp["router"], xt).numpy()
    moved = np.nonzero((got != top).any(-1))[0]
    srt = -np.sort(-probs, -1)
    k = jcfg.top_k
    gap = srt[:, k - 1] - srt[:, k]
    print(f"bf16 MoE: {len(moved)} of {len(top)} tokens routed differently")
    assert np.all(gap[moved] <= _bf16_ulp(srt[moved, k - 1]))
    keep = np.ones(len(top), bool)
    keep[moved] = False
    err = np.abs(_f32(gy) - _f32(y)).reshape(-1, jcfg.d_model)[keep]
    assert err.max() <= 0.1, err.max()


# --------------------------------------------------------------- model ----
@contextlib.contextmanager
def _record_moe_inputs():
    """Every MoE layer's input on both sides, in call order: the
    reference's by `jax.debug.callback` (it runs under jit and scan), the
    port's directly.  Restores both modules' `moe_apply` after."""
    ref, port = [], []
    j_orig, t_orig = JM.moe_apply, TM.moe_apply

    def j_rec(p, cfg, x, **kw):
        jax.debug.callback(lambda a: ref.append(np.asarray(a)), x,
                           ordered=True)
        return j_orig(p, cfg, x, **kw)

    def t_rec(p, cfg, x, **kw):
        port.append(x.detach().clone())
        return t_orig(p, cfg, x, **kw)

    JM.moe_apply, TM.moe_apply = j_rec, t_rec
    try:
        yield ref, port
    finally:
        JM.moe_apply, TM.moe_apply = j_orig, t_orig


def _reroutes(tcfg, params, ref, port):
    """Tokens routed differently on the two sides, per pass (forward,
    prefill, 3 decode steps) and layer: an (L, B, S) boolean a pass (the
    decode steps' (L, B)), true where a token's kept experts differ."""
    n = tcfg.n_layers
    routers = params_from_numpy(params)["layers"]["moe"]["router"]
    moved = []
    for c, (r, t) in enumerate(zip(ref, port)):
        rt = torch.from_numpy(np.asarray(r, np.float32)).to(t.dtype)
        m = (_kept(tcfg, routers[c % n], rt)
             != _kept(tcfg, routers[c % n], t)).any(-1)
        moved.append(m.reshape(t.shape[:2]).numpy())
    passes = [np.stack(moved[i:i + n]) for i in range(0, len(moved), n)]
    return [p[..., 0] if p.shape[2] == 1 else p for p in passes]


def _downstream(moved):
    """(B, S) tokens a reroute in the layers of `moved` (l, B, S) can
    reach: the rerouted token and, through the attention above it, every
    later token of its row."""
    if len(moved) == 0:
        return np.zeros(moved.shape[1:], bool)
    return np.maximum.accumulate(moved.any(0), axis=1)


@pytest.fixture(scope="module")
def family_runs():
    """The reference's forward, prefill and three decode steps for each
    family and dtype, computed once, with the port's seeded params carried
    across: S = 128, cache room for 8 more; the MoE layers' inputs
    recorded in bf16."""
    out = {}
    for arch in FAMILIES:
        for dtype in ("float32", "bfloat16"):
            jcfg, tcfg = _cfgs(arch, dtype)
            params = _params(tcfg, 11)
            batch = _batch(jcfg, 5, 2, S + 3)
            prompt = {k: v[:, :S] if k == "tokens" else v
                      for k, v in batch.items()}
            rec = (_record_moe_inputs() if arch in MOE and dtype ==
                   "bfloat16" else contextlib.nullcontext((None, None)))
            with rec as (ref_in, port_in):
                jp, jb = _jnp(params), _jnp(prompt)
                fwd, aux = jax.jit(partial(JM.forward, jcfg))(jp, jb)
                cache, lg = jax.jit(partial(JM.prefill_step, jcfg,
                                            cache_len=S + 8))(jp, jb)
                first = {k: np.asarray(v) for k, v in cache.items()
                         if k != "pos"}
                steps = [_f32(lg)]
                dec = jax.jit(partial(JM.decode_step, jcfg))
                for i in range(3):
                    cache, lg = dec(jp, cache, {"token": jnp.asarray(
                        batch["tokens"][:, S + i])})
                    steps.append(_f32(lg))
                jax.effects_barrier()
                got = _port_run(tcfg, params, batch)
            out[arch, dtype] = (tcfg, params, batch, _f32(fwd), float(aux),
                                first, steps, got, ref_in, port_in)
    return out


def _port_run(tcfg, params, batch):
    """The port's forward, prefill and three decode steps on the same
    inputs."""
    p, tb = params_from_numpy(params), _tb(batch)
    prompt = {k: v[:, :S] if k == "tokens" else v for k, v in tb.items()}
    fwd, aux = TM.forward(tcfg, p, prompt)
    cache, lg = TM.prefill_step(tcfg, p, prompt, cache_len=S + 8)
    # copies: decode writes the cache in place
    first = {k: _f32(v).copy() for k, v in cache.items() if k != "pos"}
    steps = [_f32(lg)]
    assert cache["pos"] == S
    for i in range(3):
        cache, lg = TM.decode_step(tcfg, p, cache,
                                   {"token": tb["tokens"][:, S + i]})
        steps.append(_f32(lg))
    assert cache["pos"] == S + 3
    return _f32(fwd), float(aux), first, steps


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_prefill_decode_match_reference(family_runs, arch, dtype):
    """Forward logits and aux, every prefill cache (k / v rings, SSM states
    and conv windows, cross k / v) and 3 decode steps' logits against the
    reference at 1e-4 (f32) / 0.1 (bf16); MoE aux at 1e-6 (f32) / 1e-2
    (bf16: a rerouted assignment moves the expert fractions by 1/(T k)).
    In bf16 the MoE archs leave out the tokens routed differently and the
    tokens after them (at most a quarter of the forward's)."""
    (tcfg, _, _, fwd, aux, first, steps, got, ref_in,
     port_in) = family_runs[arch, dtype]
    gfwd, gaux, gfirst, gsteps = got
    atol = 1e-4 if dtype == "float32" else 0.1
    n_layers, (b, s_len) = tcfg.n_layers, fwd.shape[:2]
    moved = [np.zeros((n_layers, b, s_len), bool)] * 2
    moved += [np.zeros((n_layers, b), bool)] * 3
    if ref_in is not None:
        assert len(ref_in) == len(port_in) == 5 * n_layers
        moved = _reroutes(tcfg, family_runs[arch, dtype][1], ref_in,
                          port_in)
        print(f"{arch} bf16: tokens routed differently a pass and layer "
              f"{[m.sum(-1).sum(-1).tolist() for m in moved]}")
    # a token rerouted in the last layer moves its own logits; one below
    # it, every later token of its row
    off = moved[0][-1] | _downstream(moved[0][:-1])
    assert off.mean() <= 1 / 4, off.mean()
    np.testing.assert_allclose(gfwd[~off], fwd[~off], atol=atol, rtol=0)
    aux_tol = 1e-6 if dtype == "float32" else 1e-2
    assert abs(gaux - aux) <= aux_tol and (aux > 0) == tcfg.is_moe
    assert sorted(gfirst) == sorted(first)
    for name in first:
        want, g = first[name].astype(np.float32), gfirst[name]
        assert g.shape == want.shape, name
        if ref_in is None or name not in ("k", "v"):
            np.testing.assert_allclose(g, want, atol=atol, rtol=0,
                                       err_msg=name)
            continue
        for layer in range(n_layers):
            # the MoE archs have no window: slot i holds position i
            keep = np.ones(want.shape[1:3], bool)
            keep[:, :s_len] = ~_downstream(moved[1][:layer])
            np.testing.assert_allclose(g[layer][keep], want[layer][keep],
                                       atol=atol, rtol=0, err_msg=name)
    rows = [~(moved[1][-1] | _downstream(moved[1][:-1]))[:, -1]]
    rows += [~m.any(0) for m in moved[2:]]
    for i, (g, w) in enumerate(zip(gsteps, steps)):
        np.testing.assert_allclose(g[rows[i]], w[rows[i]], atol=atol,
                                   rtol=0, err_msg=f"step {i}")


@pytest.mark.parametrize("arch", ["mamba2_370m", "hymba_1_5b"])
def test_decode_matches_forward_at_the_same_position(arch):
    """The port's decode logits equal its forward's at the same position,
    as the reference's test_decode_matches_forward holds (atol 2e-3).
    Whisper is left out: its decode adds no sinusoid (the reference's)."""
    _, tcfg = _cfgs(arch)
    p = TM.init_params(tcfg, torch.Generator().manual_seed(2), device="cpu")
    s = 32
    tokens = _t(_batch(tcfg, 3, 1, s + 3)["tokens"])
    cache, lg = TM.prefill_step(tcfg, p, {"tokens": tokens[:, :s]},
                                cache_len=s + 8)
    for i in range(3):
        full, _ = TM.forward(tcfg, p, {"tokens": tokens[:, :s + i]})
        np.testing.assert_allclose(_f32(lg), _f32(full[:, -1]), atol=2e-3,
                                   rtol=2e-3, err_msg=f"decode step {i}")
        cache, lg = TM.decode_step(tcfg, p, cache,
                                   {"token": tokens[:, s + i]})


def _grad_cfgs(arch, **over):
    """The reduced 2-layer config at d_model 32, vocab 128 (as
    `tests/test_torch_lm_train.py`)."""
    return _cfgs(arch, reduce={"n_layers": 2, "d_model": 32}, vocab=128,
                 **over)


def _leaves_close(got, want, rel):
    """Each leaf within `rel` times its own largest entry."""
    for g, w in zip(got, want):
        g, w = _f32(g), _f32(w)
        np.testing.assert_allclose(g, w, rtol=0, atol=rel * max(
            float(np.abs(w).max()), 1e-30))


@pytest.mark.parametrize("arch,s", [
    ("mamba2_370m", 128), ("kimi_k2_1t_a32b", 64),
    ("qwen3_moe_30b_a3b", 64), ("internvl2_76b", 64),
    ("hymba_1_5b", 2048), ("whisper_medium", 64)])
def test_loss_and_grads_match_the_reference(arch, s):
    """`loss_fn` (with the MoE aux term and the vision mask) and its
    gradients against `jax.value_and_grad`: the loss at 1e-5 relative,
    every leaf at 1e-4 of its largest.  Hymba at S = 2048 runs the flash
    branch with its 64-token window."""
    jcfg, tcfg = _grad_cfgs(arch)
    params = _params(tcfg, 1)
    batch = _batch(jcfg, 2, 1, s)
    loss, grads = jax.jit(jax.value_and_grad(partial(JM.loss_fn, jcfg)))(
        _jnp(params), _jnp(batch))
    tp = params_from_numpy(params)
    leaves = [x.requires_grad_() for x in tree_leaves(tp)]
    got = TM.loss_fn(tcfg, tree_unflatten(tp, leaves), _tb(batch))
    tgrads = torch.autograd.grad(got, leaves)
    np.testing.assert_allclose(float(got.detach()), float(loss), rtol=1e-5)
    _leaves_close(tgrads, jax.tree.leaves(grads), 1e-4)


@pytest.mark.parametrize("arch", ["kimi_k2_1t_a32b", "mamba2_370m"])
def test_train_step_matches_the_reference(arch):
    """One `train_step` (Kimi-K2: SGD with momentum; Mamba2: AdamW) from
    the same params and state: loss at 1e-5 relative; params at 1e-6
    (SGD) and, for AdamW, at 1e-5 but on at most 1e-3 of them (a ~0
    gradient's sign flips an AdamW step, `test_torch_lm_train.py`)."""
    jcfg, tcfg = _grad_cfgs(arch)
    params = _params(tcfg, 4)
    opt_init, step = JM.make_train_step(jcfg)
    opt = opt_init(_jnp(params))
    batch = _batch(jcfg, 10, 2, 64)
    jp, _, m = jax.jit(step)(_jnp(params), opt, _jnp(batch))
    _, tstep = TM.make_train_step(tcfg)
    tp, _, tm = tstep(params_from_numpy(params),
                      params_from_numpy(_np(opt)), _tb(batch))
    np.testing.assert_allclose(float(tm["loss"]), float(m["loss"]),
                               rtol=1e-5)
    for a, b in zip(tree_leaves(tp), jax.tree.leaves(jp)):
        err = np.abs(_f32(a) - _f32(b))
        if tcfg.optimizer == "sgd":
            assert err.max() <= 1e-6
        else:
            assert np.mean(err > 1e-5) <= 1e-3


@pytest.mark.parametrize("arch", JAX_ARCH_IDS)
def test_init_tree_matches_the_reference_and_carries_both_ways(arch):
    """The port's `init_params` makes the reference's keys and shapes
    (every family: the experts' stacks, the SSM leaves, the hybrid's
    norms, the encoder's layers), its leaves sum to `param_count`, and
    `params_to_numpy` / `params_from_numpy` carry the tree both ways
    unchanged."""
    jcfg, tcfg = _cfgs(arch)
    want = jax.eval_shape(partial(JM.init_params, jcfg), jax.random.key(0))
    own = TM.init_params(tcfg, torch.Generator().manual_seed(0),
                         device="cpu")
    paths = ["/".join(str(getattr(k, "key", k)) for k in path)
             for path, _ in jax.tree_util.tree_flatten_with_path(want)[0]]
    assert tree_paths(own) == paths
    assert [tuple(a.shape) for a in tree_leaves(own)] == [
        w.shape for w in jax.tree.leaves(want)]
    assert sum(a.numel() for a in tree_leaves(own)) == tconfig.param_count(
        tcfg)
    back = params_from_numpy(params_to_numpy(own))
    assert tree_paths(back) == paths
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(own),
                                                 tree_leaves(back)))


def test_rope_at_fraction_zero_passes_through():
    """Whisper's rope_frac 0: no rotary dims, the input unchanged on both
    sides."""
    x = np.random.default_rng(0).standard_normal((2, 5, 3, 16)).astype(
        np.float32)
    pos = np.arange(5)
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), frac=0.0,
                              theta=1e4)
    got = tlayers.apply_rope(_t(x), _t(pos), frac=0.0, theta=1e4)
    np.testing.assert_array_equal(_f32(got), x)
    np.testing.assert_array_equal(_f32(want), x)


# ------------------------------------------------------------- serving ----
def _jax_serve(cfg, params, batch, gen_len):
    """The loop of examples/serve_shapley.py, in JAX, with the frontend
    stub's input in the prefill batch."""
    tokens = batch["tokens"]
    cache, logits = jax.jit(partial(JM.prefill_step, cfg,
                                    cache_len=tokens.shape[1] + gen_len))(
        params, batch)
    dec = jax.jit(partial(JM.decode_step, cfg))
    out, lp_sum = [], jnp.zeros((tokens.shape[0],))
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    for _ in range(gen_len):
        out.append(tok)
        cache, logits = dec(params, cache, {"token": tok})
        lp = jax.nn.log_softmax(logits, -1)
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        lp_sum += jnp.take_along_axis(lp, tok[:, None], 1)[:, 0]
    b = tokens.shape[0]
    stacked = jax_tree_stack([{"lp": lp_sum[r][None]} for r in range(b)])
    sv = jax_exact_shapley(stacked, jnp.ones(b), {"lp": jnp.zeros(1)},
                           lambda p: jnp.sum(p["lp"]))
    return np.asarray(jnp.stack(out, 1)), np.asarray(lp_sum), np.asarray(sv)


@pytest.mark.parametrize("arch,s", [("mamba2_370m", 64),
                                    ("whisper_medium", 40)])
def test_serve_requests_matches_the_reference_loop(arch, s):
    """`serve_requests` on an attention-free cache (Mamba2) and with audio
    frames (Whisper): the same greedy tokens, log-prob sums and SVs at
    1e-4."""
    jcfg, tcfg = _cfgs(arch)
    params = _params(tcfg, 7)
    batch = _batch(jcfg, 9, 4, s)
    gen, lp, sv = _jax_serve(jcfg, _jnp(params), _jnp(batch), 5)
    tb = _tb(batch)
    res = serve_requests(tcfg, params_from_numpy(params), tb["tokens"], 5,
                         device="cpu", frames=tb.get("frames"))
    np.testing.assert_array_equal(res.generated.numpy(), gen)
    np.testing.assert_allclose(res.logprob_sum.numpy(), lp, atol=1e-4)
    np.testing.assert_allclose(res.sv.numpy(), sv, atol=1e-4)
    np.testing.assert_allclose(float(res.sv.sum()),
                               float(res.logprob_sum.mean()), atol=1e-4)


@pytest.mark.parametrize("arch", ["internvl2_76b", "whisper_medium",
                                  "mamba2_370m"])
def test_synth_batch_draws_the_frontend_inputs(arch):
    """The launcher's batch: tokens, plus normal patches (B,
    n_frontend_tokens, D) for vision and normal frames (B, max(
    n_frontend_tokens, 8), D) for audio, as the reference's launcher
    draws them; one LM-mode step runs on it."""
    _, tcfg = _grad_cfgs(arch)
    params, opt, step, gen = launch_train.build_lm(tcfg, 0, "cpu")
    batch = launch_train.synth_batch(tcfg, gen, 3, 64)
    want = {"tokens"} | ({"patches"} if tcfg.frontend == "vision" else
                         {"frames"} if tcfg.frontend == "audio" else set())
    assert set(batch) == want
    assert batch["tokens"].shape == (3, 64)
    for name in want - {"tokens"}:
        x = batch[name]
        n = (tcfg.n_frontend_tokens if name == "patches"
             else max(tcfg.n_frontend_tokens, 8))
        assert x.shape == (3, n, tcfg.d_model) and x.dtype == torch.float32
        assert abs(float(x.std()) - 1) < 0.2
    _, _, m = step(params, opt, batch)
    assert np.isfinite(float(m["loss"]))
