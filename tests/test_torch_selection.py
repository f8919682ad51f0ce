"""The port's selectors and per-leaf upload codecs against the reference's.

Selections are compared bitwise over multi-round runs; the randomised
strategies get the reference's own Gumbel / choice draws from its key.
Codecs: keep-masks bitwise (ties broken lowest index first, like
`lax.top_k`), byte counts equal, reconstructions at 1e-6 (quant8 scales
are f32 divisions that both frameworks round the same way).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import selection_jax as jsel
from repro.federated import compression as jcomp
from repro_torch.core import selection as sel
from repro_torch.federated import compression as comp
from repro_torch.interop import params_from_numpy
from repro_torch.tree import tree_leaves

N, M, T = 10, 3, 8


def key_draw(key, n=N, m=M):
    """The reference's selection draws (cohort and Gumbel noise) from its
    own key."""
    return sel.SelectionDraw(
        choice=torch.tensor(np.asarray(jax.random.choice(
            key, n, (m,), replace=False))),
        gumbel=torch.tensor(np.asarray(jax.random.gumbel(
            key, (n,), jnp.float32))))


KWARGS = {
    "random": {}, "fedavg": {}, "power_of_choice": {"decay": 0.7},
    "s_fedavg": {"beta": 0.4, "temperature": 0.5}, "ucb": {"c": 0.2},
    "greedyfed": {}, "greedyfed_dropout": {"drop_frac": 0.4},
}


@pytest.mark.parametrize("name", sorted(KWARGS))
def test_selections_bitwise_over_a_run(name):
    jspec = jsel.make_selector_spec(name, N, M, **KWARGS[name])
    tspec = sel.make_selector_spec(name, N, M, **KWARGS[name])
    assert tuple(tspec) == tuple(jspec)
    assert (tspec.uses_shapley, tspec.uses_local_losses, tspec.rr_rounds,
            tspec.n_keep) == (jspec.uses_shapley, jspec.uses_local_losses,
                              jspec.rr_rounds, jspec.n_keep)
    np.testing.assert_array_equal(sel.poc_d_schedule(tspec, T),
                                  jsel.poc_d_schedule(jspec, T))
    jstate = jsel.init_device_state(jspec, seed=3)
    tstate = sel.init_device_state(tspec, seed=3)
    np.testing.assert_array_equal(tstate.rr_order.numpy(),
                                  np.asarray(jstate.rr_order))
    rng = np.random.default_rng(7)
    fractions = rng.dirichlet(np.ones(N)).astype(np.float32)
    keys = jax.random.split(jax.random.key(11), T)
    d_sched = jsel.poc_d_schedule(jspec, T)
    for t in range(T):
        losses = rng.random(N).astype(np.float32)
        losses[rng.integers(N)] = losses[rng.integers(N)]    # a tie
        jctx = jsel.DeviceSelectionContext(jnp.asarray(fractions),
                                           jnp.asarray(losses),
                                           jnp.asarray(d_sched[t]))
        tctx = sel.DeviceSelectionContext(torch.from_numpy(fractions),
                                          torch.from_numpy(losses),
                                          int(d_sched[t]))
        jchosen, jstate = jsel.device_select(jspec, jstate, keys[t], jctx)
        tchosen, tstate = sel.device_select(tspec, tstate, tctx,
                                            key_draw(keys[t]))
        np.testing.assert_array_equal(tchosen.numpy(), np.asarray(jchosen),
                                      err_msg=f"round {t}")
        sv = np.round(rng.standard_normal(M), 1).astype(np.float32)  # ties
        jstate = jsel.device_update(jspec, jstate, jchosen, jnp.asarray(sv))
        tstate = sel.device_update(tspec, tstate, tchosen, torch.from_numpy(sv))
    np.testing.assert_allclose(tstate.valuation.sv.numpy(),
                               np.asarray(jstate.valuation.sv), atol=1e-7)
    np.testing.assert_array_equal(tstate.valuation.counts.numpy(),
                                  np.asarray(jstate.valuation.counts))
    np.testing.assert_array_equal(tstate.active.numpy(),
                                  np.asarray(jstate.active))
    assert tstate.frozen == bool(jstate.frozen)


def test_selector_registry_matches_reference():
    assert sel.strategy_names() == jsel.strategy_names()
    with pytest.raises(ValueError):
        sel.make_selector_spec("oracle", N, M)
    with pytest.raises(TypeError):
        sel.make_selector_spec("ucb", N, M, beta=1.0)
    assert tuple(sel.make_selector_spec("power_of_choice", N, M, d0=0)) == \
        tuple(jsel.make_selector_spec("power_of_choice", N, M, d0=0))


def _delta_tree(seed, ties=False):
    rng = np.random.default_rng(seed)
    tree = {"layer0": {"w": rng.standard_normal((30, 20)).astype(np.float32),
                       "b": rng.standard_normal((20,)).astype(np.float32)},
            "layer1": {"w": rng.standard_normal((20, 7)).astype(np.float32),
                       "b": np.zeros((7,), np.float32)}}
    if ties:   # coarse values: many equal magnitudes straddle the top-k cut
        tree = jax.tree.map(lambda a: np.round(a * 2) / 2, tree)
    return tree


@pytest.mark.parametrize("codec", ["identity", "quant8", "topk",
                                   "quant8_topk"])
@pytest.mark.parametrize("ties", [False, True])
def test_codecs_match_reference(codec, ties):
    w_ref = _delta_tree(0)
    w_new = jax.tree.map(lambda a, d: (a + d).astype(np.float32), w_ref,
                         _delta_tree(1, ties))
    want, want_bytes = jcomp.compress_update(
        codec, jax.tree.map(jnp.asarray, w_new),
        jax.tree.map(jnp.asarray, w_ref))
    got, got_bytes = comp.compress_update(codec, params_from_numpy(w_new),
                                          params_from_numpy(w_ref))
    assert got_bytes == want_bytes
    assert comp.codec_nbytes(codec, params_from_numpy(w_ref)) == \
        jcomp.codec_nbytes(codec, jax.tree.map(jnp.asarray, w_ref))
    ref_leaves = jax.tree.leaves(w_ref)
    for g, w, r in zip(tree_leaves(got), jax.tree.leaves(want), ref_leaves):
        g, w = g.numpy(), np.asarray(w)
        np.testing.assert_array_equal(g != r, w != r)        # keep-mask
        np.testing.assert_allclose(g, w, atol=1e-6, rtol=0)
    rt = comp.codec_roundtrip(codec, params_from_numpy(w_new),
                              params_from_numpy(w_ref))
    for a, b in zip(tree_leaves(rt), tree_leaves(got)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_topk_ties_keep_lowest_indices_like_lax_top_k():
    flat = np.array([1.0, -3.0, 2.0, 3.0, -2.0, 3.0, 0.5], np.float32)
    for k in range(1, 8):
        want = np.asarray(jax.lax.top_k(jnp.abs(jnp.asarray(flat)), k)[1])
        got = comp.topk_indices(torch.from_numpy(flat), k).numpy()
        np.testing.assert_array_equal(got, want)
    for n in (1, 9, 10, 156800):
        assert comp.leaf_topk_k(n) == jcomp.leaf_topk_k(n)
