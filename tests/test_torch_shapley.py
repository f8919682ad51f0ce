"""The port's GTG-Shapley estimators against the reference's.

The walks are drawn by the reference from its key and injected into the
port, so both compute the same Monte-Carlo average and differ only in
float32 rounding.  Tolerances: SV at 1e-5 absolute on the MLP utility
(sums of ~n_perms marginals of f32 losses), 1e-6 on the toy quadratic
utility; chunking within the port is compared bitwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.aggregation import tree_stack as jax_tree_stack
from repro.core.shapley import exact_shapley as jax_exact
from repro.core.shapley import gtg_shapley as jax_gtg
from repro.core.shapley_batched import _draw_perms as jax_draw_perms
from repro.core.shapley_batched import _walk_sv as jax_walk_sv
from repro.core.shapley_batched import (
    gtg_shapley_streaming as jax_streaming,
    make_batched_mlp_utility as jax_batched_utility,
)
from repro.models.mlp_cnn import make_mlp as jax_make_mlp
from repro_torch.core.aggregation import tree_stack
from repro_torch.core.shapley import (
    exact_shapley, gtg_shapley, permutation_block,
)
from repro_torch.core.shapley_batched import (
    _draw_perms, _walk_sv, chunk_walks_for, gtg_shapley_streaming,
    make_batched_mlp_utility,
)
from repro_torch.interop import params_from_numpy
from repro_torch.models.mlp_cnn import make_mlp
from test_torch_server import jax_walk_block


def _t(a, dtype=None):
    t = torch.tensor(np.asarray(a))
    return t.to(dtype) if dtype is not None else t


def _mlp_case(m=3, seed=0):
    """Both packages' views of M client MLPs (64 -> 40 -> 10, so layer0/w
    has D = 2560 >= 2048 and takes the reference's kernel branch)."""
    jm, tm = jax_make_mlp(64, (40,), 10), make_mlp(64, (40,), 10)
    clients = [jm.init(jax.random.key(seed + i)) for i in range(m)]
    w_prev = jm.init(jax.random.key(seed + 99))
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((48, 64)).astype(np.float32)
    y = rng.integers(0, 10, size=48).astype(np.int32)
    n_k = np.arange(1, m + 1, dtype=np.float32) * 5

    def j_util(p):
        return -jm.loss(p, jnp.asarray(x), jnp.asarray(y))

    def t_util(p):
        return -tm.loss(p, _t(x), _t(y))

    jax_side = (jax_tree_stack(clients), jnp.asarray(n_k), w_prev, j_util,
                jax_batched_utility(jm, jnp.asarray(x), jnp.asarray(y)))
    port_side = (tree_stack([params_from_numpy(jax.tree.map(np.asarray, c))
                             for c in clients]), _t(n_k),
                 params_from_numpy(jax.tree.map(np.asarray, w_prev)), t_util,
                 make_batched_mlp_utility(tm, _t(x), _t(y)))
    return jax_side, port_side


@pytest.mark.parametrize("n_perms", [12, 7])
def test_streaming_sv_matches_reference_on_same_walks(n_perms):
    m = 3
    (jax_args, port_args) = _mlp_case(m)
    key = jax.random.key(5)
    want, wstats = jax_streaming(*jax_args, key, n_perms=n_perms,
                                 use_kernel=True)
    perms = _t(jax_draw_perms(key, m, n_perms), torch.int64)
    got, stats = gtg_shapley_streaming(*port_args, perms)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    assert stats.utility_evals == int(wstats.utility_evals) == n_perms * m + 2
    assert stats.iterations == int(wstats.iterations) == n_perms
    assert stats.truncated_round is bool(wstats.truncated_round) is False
    np.testing.assert_allclose(stats.v0, float(wstats.v0), rtol=1e-6)
    np.testing.assert_allclose(stats.vM, float(wstats.vM), rtol=1e-6)


def test_streaming_chunking_is_bitwise_invariant_in_the_port():
    m, n_perms = 3, 10
    _, port_args = _mlp_case(m, seed=1)
    perms = _draw_perms(torch.Generator().manual_seed(0), m, n_perms)
    base, base_stats = gtg_shapley_streaming(*port_args, perms)
    for sv_chunk in (1, m, 7, n_perms * m, -1):
        got, stats = gtg_shapley_streaming(*port_args, perms,
                                           sv_chunk=sv_chunk)
        np.testing.assert_array_equal(got.numpy(), base.numpy())
        walks = chunk_walks_for(sv_chunk, n_perms, m, torch.device("cpu"))
        assert stats.utility_evals == -(-n_perms // walks) * walks * m + 2
    assert base_stats.utility_evals == n_perms * m + 2


def test_chunk_resolution_matches_reference_rule():
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert chunk_walks_for(0, 250, 5, cpu) == 1
    assert chunk_walks_for(0, 250, 5, cuda) == 250
    assert chunk_walks_for(-1, 250, 5, cpu) == 250
    assert chunk_walks_for(7, 250, 5, cpu) == 2
    assert chunk_walks_for(10_000, 250, 5, cpu) == 250


def _toy(m=4, d=3, seed=0):
    rng = np.random.default_rng(seed)
    clients = [rng.standard_normal(d).astype(np.float32) for _ in range(m)]
    target = rng.standard_normal(d).astype(np.float32)
    n_k = np.arange(1.0, m + 1.0, dtype=np.float32) * 10
    jax_side = ({"w": jnp.stack([jnp.asarray(c) for c in clients])},
                jnp.asarray(n_k), {"w": jnp.zeros(d)},
                lambda p: -jnp.sum((p["w"] - target) ** 2))
    tt = _t(target)
    port_side = ({"w": _t(np.stack(clients))}, _t(n_k),
                 {"w": torch.zeros(d)},
                 lambda p: -torch.sum((p["w"] - tt) ** 2, dim=-1))
    return jax_side, port_side


def test_exact_shapley_matches_reference():
    jax_args, port_args = _toy()
    want = jax_exact(*jax_args)
    got = exact_shapley(*port_args)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    # efficiency: the SVs sum to U(all) - U(empty)
    np.testing.assert_allclose(float(got.sum()), float(np.asarray(want).sum()),
                               atol=1e-6)


def test_streaming_converges_to_the_exact_oracle():
    _, (stacked, n_k, w_prev, util) = _toy()
    perms = _draw_perms(torch.Generator().manual_seed(1), 4, 512)
    got, _ = gtg_shapley_streaming(stacked, n_k, w_prev, util, util, perms)
    np.testing.assert_allclose(got.numpy(),
                               exact_shapley(stacked, n_k, w_prev, util).numpy(),
                               atol=0.25)


def test_serial_gtg_matches_reference_with_injected_walks():
    jax_args, port_args = _toy(seed=3)
    key = jax.random.key(2)
    want, wstats = jax_gtg(*jax_args, key, eps=1e-7, max_iters=40)
    got, stats = gtg_shapley(*port_args, jax_walk_block(key, 4, 40),
                             eps=1e-7, max_iters=40)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    assert stats.iterations == int(wstats.iterations)
    assert stats.utility_evals == int(wstats.utility_evals)
    assert stats.truncated_round is bool(wstats.truncated_round) is False


def test_between_round_truncation_matches_reference():
    jax_args, port_args = _toy(m=3)
    jstacked, jn, _, jutil = jax_args
    stacked, n_k, _, util = port_args
    # w_prev = the full average => |v_M - v_0| = 0 < eps
    w_full = {"w": (n_k[:, None] * stacked["w"]).sum(0) / n_k.sum()}
    jw_full = {"w": jnp.asarray(w_full["w"].numpy())}
    perms = _draw_perms(torch.Generator().manual_seed(0), 3, 6)
    sv, stats = gtg_shapley_streaming(stacked, n_k, w_full, util, util, perms)
    want, wstats = jax_streaming(jstacked, jn, jw_full, jutil, jax.vmap(jutil),
                                 jax.random.key(0), n_perms=6, use_kernel=False)
    assert stats.truncated_round and bool(wstats.truncated_round)
    assert stats.iterations == int(wstats.iterations) == 0
    assert stats.utility_evals == int(wstats.utility_evals) == 2
    np.testing.assert_array_equal(sv.numpy(), np.asarray(want))
    sv_s, stats_s = gtg_shapley(stacked, n_k, w_full, util,
                                permutation_block(
                                    torch.Generator().manual_seed(0), 3, 9),
                                max_iters=9)
    assert stats_s.truncated_round and stats_s.utility_evals == 2
    assert float(sv_s.abs().sum()) == 0.0


def test_walk_sv_matches_reference():
    rng = np.random.default_rng(4)
    r, m = 9, 4
    vs = rng.standard_normal((r, m)).astype(np.float32)
    perms = np.stack([rng.permutation(m) for _ in range(r)])
    v0 = np.float32(0.3)
    want = jax_walk_sv(jnp.asarray(vs), jnp.asarray(perms), jnp.asarray(v0),
                       r, m)
    got = _walk_sv(_t(vs), _t(perms, torch.int64), _t(v0), r, m)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("m,n_perms", [(4, 8), (5, 13), (1, 3)])
def test_draw_perms_are_balanced_walks(m, n_perms):
    perms = _draw_perms(torch.Generator().manual_seed(m), m, n_perms)
    assert perms.shape == (n_perms, m) and perms.dtype == torch.int64
    for row in perms.tolist():
        assert sorted(row) == list(range(m))
    batch = permutation_block(torch.Generator().manual_seed(0), m, 1)
    assert batch[:, 0].tolist() == list(range(m))
    if n_perms % m == 0:
        counts = torch.bincount(perms[:, 0], minlength=m)
        assert counts.tolist() == [n_perms // m] * m
