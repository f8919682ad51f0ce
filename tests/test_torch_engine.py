"""The port's batched round engine, its dense Shapley oracle and their
kernels (`cohort_gather`, `weighted_avg`) on the CPU, against the
reference.

Inputs are made with numpy from fixed seeds and go through both packages.
Tolerances: the gathers are bitwise (a gather copies bits); weighted_avg at
rtol 1e-6 (f32 sums of M products in another order); prefix weights
bitwise (integer sums, one IEEE division); the dense SV at 1e-5 on the MLP
utility (sums of n_perms marginals of f32 losses); whole runs at 1e-4
against the reference (4 rounds of local SGD, averaging and walks taken in
other orders by the two frameworks) and at 1e-5 between the port's two
engines.  Whole runs replay the reference's draws through
`test_torch_server.JaxReplayDraws`, which serves both reference engines:
the batched engine splits its round key exactly as the loop does.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.shapley_batched import _draw_perms as jax_draw_perms
from repro.core.shapley_batched import (
    gtg_shapley_batched as jax_dense, prefix_weight_matrix as jax_pwm,
)
from repro.federated.client import ClientConfig as JaxClientConfig
from repro.federated.server import FLConfig as JaxFLConfig
from repro.federated.server import run_federated as jax_run_federated
from repro.kernels.cohort_gather import cohort_take as jax_cohort_take
from repro.kernels.cohort_gather.kernel import (
    cohort_gather_kernel as jax_gather_kernel,
)
from repro.kernels.cohort_gather.ref import cohort_gather_ref as jax_gather_ref
from repro.kernels.weighted_avg import weighted_avg as jax_weighted_avg
from repro.models.mlp_cnn import make_mlp as jax_make_mlp
from repro_torch import kernels
from repro_torch.core.shapley_batched import (
    gtg_shapley_batched, gtg_shapley_streaming, make_batched_mlp_utility,
    prefix_weight_matrix,
)
from repro_torch.engine import (
    RoundEngine, RoundSpec, batched_client_update, cohort_update,
    make_round_step,
)
from repro_torch.faults import FaultSpec
from repro_torch.federated.client import ClientConfig, client_update
from repro_torch.federated.compression import codec_nbytes
from repro_torch.federated.server import FLConfig, run_federated, setup_run
from repro_torch.interop import params_from_numpy
from repro_torch.kernels.cohort_gather import (
    cohort_gather, cohort_gather_ref, cohort_take,
)
from repro_torch.kernels.cohort_gather.kernel import (
    MAX_IDS, checked_ids, cohort_gather_cuda,
)
from repro_torch.kernels.cohort_gather.kernel import (
    launch_plan as gather_plan,
)
from repro_torch.kernels.weighted_avg import weighted_avg, weighted_avg_ref
from repro_torch.kernels.weighted_avg.kernel import (
    launch_plan as wavg_plan, rows_per_block, weighted_avg_cuda,
)
from repro_torch.models.mlp_cnn import make_mlp
from repro_torch.tree import tree_leaves, tree_map
from test_torch_server import JaxReplayDraws


def _t(a, dtype=None):
    t = torch.tensor(np.asarray(a))
    return t.to(dtype) if dtype is not None else t


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


# ---------------------------------------------------------- cohort_gather --
def _table(rng, n, d, dtype):
    if dtype == np.int32:
        return rng.integers(-2**31, 2**31 - 1, size=(n, d), dtype=np.int32)
    t = rng.standard_normal((n, d)).astype(np.float32)
    t[1, ::3] = -0.0
    bits = t.view(np.int32)
    bits[2, ::5] = np.int32(0x7fc01234)              # NaN with a payload
    bits[3, 1::4] = np.int32(-0x3fe0_0001)           # negative NaN payload
    return t


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("d", [6, 2049, 4096])
def test_cohort_gather_plain_bitwise_equals_reference(dtype, d):
    rng = np.random.default_rng(d)
    table = _table(rng, 7, d, dtype)
    ids = np.array([3, 1, 2, 2, 6], np.int64)
    got = cohort_gather_ref(torch.from_numpy(table), torch.from_numpy(ids))
    want = jax_gather_ref(jnp.asarray(table), jnp.asarray(ids))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    if d % 2048 == 0:       # the reference's Pallas kernel, interpreted
        pallas = jax_gather_kernel(jnp.asarray(table), jnp.asarray(ids),
                                   interpret=True)
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(pallas))


def test_cohort_gather_tree_wrapper_matches_reference_on_client_stacks():
    """The four client stacks the batched engine gathers every round."""
    rng = np.random.default_rng(1)
    stacks = {"xs": rng.standard_normal((6, 9, 28, 28)).astype(np.float32),
              "ys": rng.integers(0, 10, size=(6, 9)).astype(np.int64),
              "nv": rng.integers(1, 9, size=6).astype(np.int64),
              "sigma": rng.random(6).astype(np.float32)}
    stacks["xs"][4, 0, 0, :3] = -0.0
    ids = np.array([4, 0, 5])
    before = dict(kernels.LAUNCHES)
    got = cohort_gather(tree_map(torch.from_numpy, stacks),
                        torch.from_numpy(ids))
    assert kernels.LAUNCHES == before        # the CPU never counts a launch
    for name, leaf in stacks.items():
        want = jax_cohort_take(jnp.asarray(leaf), jnp.asarray(ids))
        assert tuple(got[name].shape) == want.shape
        np.testing.assert_array_equal(_bits(got[name].numpy()),
                                      _bits(np.asarray(want)))


def test_cohort_gather_rejects_bad_ids_and_the_sharded_path():
    table = torch.zeros((4, 3))
    with pytest.raises(IndexError):
        cohort_take(table, torch.tensor([0, 4]))
    with pytest.raises(IndexError):
        cohort_take(table, torch.tensor([-5]))
    # the sharded path runs since the client-sharding slice, over a client
    # mesh (tests/test_torch_client_sharding.py); with none made, the axis
    # name names nothing
    with pytest.raises(ValueError, match="no client mesh"):
        cohort_take(table, torch.tensor([0]), axis_name="clients")
    with pytest.raises(ValueError, match="CUDA"):
        cohort_gather_cuda([table], [0])
    with pytest.raises(ValueError, match="integers"):
        checked_ids(torch.tensor([0.0]), 4)


@pytest.mark.parametrize("ids,n,error", [
    (np.array([0, 4]), 4, IndexError), ([-1], 4, IndexError),
    (torch.tensor([2, 1 << 40]), 4, IndexError),
    (torch.tensor([3, -5], dtype=torch.int32), 4, IndexError),
    (np.arange(MAX_IDS + 1) % 4, 4, ValueError),
    (np.zeros((2, 2), np.int64), 4, ValueError),
    (np.array([1.0, 2.0]), 4, ValueError)])
def test_cohort_gather_host_id_check_rejects(ids, n, error):
    """The card's gather checks its ids on the host before it launches:
    out of range as index_select does (IndexError), more than the kernel's
    parameters hold, not 1-D or not integers (ValueError).  A CUDA tensor
    takes the same path after its copy to the host (the gpu tests)."""
    with pytest.raises(error):
        checked_ids(ids, n)


@pytest.mark.parametrize("ids", [
    [3, 0, 3], np.array([3, 0, 3], np.int32), torch.tensor([3, 0, 3]),
    np.array([3, 9, 0, 9, 3])[::2]])
def test_cohort_gather_host_ids_are_python_ints(ids):
    got = checked_ids(ids, 4)
    assert got == [3, 0, 3] and all(type(i) is int for i in got)
    assert len(checked_ids(np.arange(MAX_IDS) % 4, 4)) == MAX_IDS


# (row bytes, table / output pointer offsets) -> (unit, blk0, blocks)
_XS, _YS, _NV, _SG = 495488, 1264, 8, 4      # the main path's four rows
_A = 1 << 20                                  # a 16-byte aligned address


@pytest.mark.parametrize("leaves,want,total", [
    ([(_XS, _A, _A), (_YS, _A, _A), (_NV, _A, _A), (_SG, _A, _A)],
     [(16, 0, 31), (16, 31, 1), (4, 32, 1), (4, 33, 1)], 34),
    ([(6, _A, _A)], [(1, 0, 1)], 1),                     # 3 bf16 a row
    ([(8196, _A, _A)], [(4, 0, 3)], 3),                  # 2049 f32
    ([(_XS, _A + 4, _A), (_XS, _A, _A + 8)], [(4, 0, 121), (4, 121, 121)],
     242),
    ([(_XS, _A + 2, _A), (16384, _A, _A)], [(1, 0, 484), (16, 484, 1)],
     485)])
def test_cohort_gather_launch_plan(leaves, want, total):
    """Each leaf's word is the widest of 16, 4 or 1 bytes on which its rows
    and both base pointers fall, and its chunks of 256 threads x 4 words
    follow the previous leaf's along grid.x."""
    plans, blocks = gather_plan(leaves)
    assert [tuple(p) for p in plans] == want and blocks == total


# ----------------------------------------------------------- weighted_avg --
@pytest.mark.parametrize("d", [200, 1000, 4096])
def test_weighted_avg_plain_matches_reference(d):
    """D < 2048 goes through the reference's jnp ref, D = 4096 through its
    Pallas kernel in interpret mode."""
    rng = np.random.default_rng(d)
    m, r = 5, 12
    stacked = rng.standard_normal((m, d)).astype(np.float32)
    weights = rng.random((r, m)).astype(np.float32)
    want = jax_weighted_avg({"w": jnp.asarray(stacked)}, jnp.asarray(weights),
                            use_kernel=True, interpret=True)["w"]
    got = weighted_avg({"w": torch.from_numpy(stacked)},
                       torch.from_numpy(weights))["w"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(
        weighted_avg_ref(torch.from_numpy(stacked),
                         torch.from_numpy(weights)).numpy(),
        np.asarray(want), rtol=1e-6, atol=1e-7)


def _exact_fma(a, b, c) -> np.ndarray:
    """float32 round(a * b + c) with rationals, ties to even."""
    from fractions import Fraction
    out = np.empty(a.shape, np.float32)
    for i in range(a.size):
        x = (Fraction(float(a.flat[i])) * Fraction(float(b.flat[i]))
             + Fraction(float(c.flat[i])))
        f = np.float32(float(x))
        near = [np.nextafter(f, np.float32(-np.inf)), f,
                np.nextafter(f, np.float32(np.inf))]
        out.flat[i] = min(near, key=lambda y: (abs(Fraction(float(y)) - x),
                                               int(y.view(np.int32)) & 1))
    return out


@pytest.mark.parametrize("case", ["normal", "ties", "subnormal", "clamped"])
def test_weighted_avg_plain_fma_is_exact(case):
    """The plain version's float32 fma, emulated in float64, rounds once:
    checked against rationals, on ties a float64 sum would round wrongly
    (c = 2^20 + 2^-3, a * b = 2^-4 - 2^-50 sums to the float64 midpoint
    2^20 + 2^-4 + 2^-3 and must round down to c), subnormal products
    (2^-100 times entries below 2^-26) and the dense oracle's clamped
    ~7.9e-19 weights."""
    from repro_torch.kernels.weighted_avg.ref import fma_f32
    rng = np.random.default_rng(1)
    n = 400
    if case == "normal":
        a, b, c = (rng.standard_normal(n) for _ in range(3))
    elif case == "ties":
        a = np.full(n, 1 + 2.0 ** -23)
        b = 2.0 ** -4 * (1 + rng.choice([-1, 1], n) * 2.0 ** -23)
        c = 2.0 ** 20 + rng.integers(0, 64, n) * 2.0 ** -3
    elif case == "subnormal":
        a = np.full(n, 2.0 ** -100)
        b = rng.standard_normal(n) * 2.0 ** -40
        c = rng.standard_normal(n) * 2.0 ** -140
    else:
        a = np.full(n, 2.0 ** -100 / 1e-12)
        b = rng.standard_normal(n)
        c = rng.standard_normal(n) * 1e-18
    a, b, c = (np.asarray(v, np.float32) for v in (a, b, c))
    got = fma_f32(torch.from_numpy(a), torch.from_numpy(b),
                  torch.from_numpy(c)).numpy()
    np.testing.assert_array_equal(got.view(np.int32),
                                  _exact_fma(a, b, c).view(np.int32))


def test_weighted_avg_plain_bf16_and_tree_shapes_match_reference():
    rng = np.random.default_rng(3)
    tree = {"a": rng.standard_normal((3, 20, 30)).astype(np.float32),
            "b": rng.standard_normal((3, 30)).astype(np.float32)}
    weights = rng.random((7, 3)).astype(np.float32)
    want = jax_weighted_avg(
        jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16), tree),
        jnp.asarray(weights))
    got = weighted_avg(tree_map(lambda x: torch.from_numpy(x).bfloat16(),
                                tree), torch.from_numpy(weights))
    for name in tree:
        assert got[name].dtype == torch.bfloat16
        assert tuple(got[name].shape) == want[name].shape == \
            (7,) + tree[name].shape[1:]
        np.testing.assert_allclose(got[name].float().numpy(),
                                   np.asarray(want[name], np.float32),
                                   rtol=8e-3, atol=1e-6)


def test_weighted_avg_launcher_checks():
    s, w = torch.zeros((3, 8)), torch.zeros((2, 3))
    with pytest.raises(ValueError, match="CUDA"):
        weighted_avg_cuda([s], w)
    with pytest.raises(TypeError):
        weighted_avg_cuda([s.double()], w.double())
    with pytest.raises(ValueError, match="weights"):
        weighted_avg_cuda([s], w.T.contiguous())
    with pytest.raises(ValueError, match="weights"):
        weighted_avg_cuda([s, s.bfloat16()], w)
    assert [rows_per_block(m) for m in (1, 5, 192, 193, 12288)] == \
        [64, 64, 64, 63, 1]


# the MLP's six leaves in tree order: layer0/b, layer0/w, layer1/b,
# layer1/w, layer2/b, layer2/w
_MLP_D = (200, 156800, 100, 20000, 10, 1000)


@pytest.mark.parametrize("widths,itemsize,offset,want,total", [
    (_MLP_D, 4, 0, [(4, 0, 1), (4, 1, 154), (4, 155, 1), (4, 156, 20),
                    (1, 176, 1), (4, 177, 1)], 178),
    (_MLP_D, 2, 0, [(8, 0, 1), (8, 1, 77), (1, 78, 1), (8, 79, 10),
                    (1, 89, 1), (8, 90, 1)], 91),
    ((156800, 2049), 4, 0, [(4, 0, 154), (1, 154, 9)], 163),
    ((156800, 1000), 4, 8, [(1, 0, 613), (1, 613, 4)], 617),
    ((20000,), 2, 4, [(1, 0, 79)], 79)])
def test_weighted_avg_launch_plan(widths, itemsize, offset, want, total):
    """A leaf takes 16-byte words (4 f32 or 8 bf16 columns a thread) when D
    is a multiple of the word and its stack and output start on 16-byte
    boundaries, else one column a thread; its column blocks of 256 threads
    follow the previous leaf's along grid.x, all in one launch."""
    base = 1 << 20
    plans, blocks = wavg_plan([(d, base + offset, base) for d in widths],
                              itemsize)
    assert [tuple(p) for p in plans] == want and blocks == total


# ------------------------------------------------------- the dense oracle --
def _mlp_case(m=3, seed=0):
    """M client MLPs 64 -> 40 -> 10 (layer0/w has D = 2560, so the
    reference's dense oracle takes its Pallas kernel, interpreted)."""
    jm, tm = jax_make_mlp(64, (40,), 10), make_mlp(64, (40,), 10)
    rng = np.random.default_rng(seed)
    w_prev = jax.tree.map(np.asarray, jm.init(jax.random.key(seed)))
    clients = jax.tree.map(
        lambda p: p[None] + (0.3 * rng.standard_normal((m,) + p.shape)
                             ).astype(np.float32), w_prev)
    x = rng.standard_normal((48, 64)).astype(np.float32)
    y = rng.integers(0, 10, size=48).astype(np.int32)
    n_k = np.arange(1, m + 1, dtype=np.float32) * 5
    from repro.core.shapley_batched import (
        make_batched_mlp_utility as jax_batched_utility,
    )
    jax_side = (jax.tree.map(jnp.asarray, clients), jnp.asarray(n_k),
                jax.tree.map(jnp.asarray, w_prev),
                lambda p: -jm.loss(p, jnp.asarray(x), jnp.asarray(y)),
                jax_batched_utility(jm, jnp.asarray(x), jnp.asarray(y)))
    port_side = (params_from_numpy(clients), _t(n_k),
                 params_from_numpy(w_prev),
                 lambda p: -tm.loss(p, _t(x), _t(y).long()),
                 make_batched_mlp_utility(tm, _t(x), _t(y).long()))
    return jax_side, port_side


def test_prefix_weight_matrix_bitwise_equals_reference():
    rng = np.random.default_rng(4)
    perms = np.stack([rng.permutation(5) for _ in range(9)])
    n_k = rng.integers(1, 400, size=5).astype(np.float32)
    got = prefix_weight_matrix(torch.from_numpy(perms), torch.from_numpy(n_k))
    want = jax_pwm(jnp.asarray(perms), jnp.asarray(n_k))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    np.testing.assert_allclose(got.numpy().sum(-1), 1.0, rtol=1e-6)


@pytest.mark.parametrize("n_perms", [12, 7])
def test_dense_sv_matches_reference_on_same_walks(n_perms):
    m = 3
    jax_args, port_args = _mlp_case(m)
    key = jax.random.key(5)
    want, wstats = jax_dense(*jax_args, key, n_perms=n_perms)
    perms = _t(jax_draw_perms(key, m, n_perms), torch.int64)
    got, stats = gtg_shapley_batched(*port_args, perms)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    assert stats.utility_evals == int(wstats.utility_evals) == n_perms * m + 2
    assert stats.iterations == int(wstats.iterations) == n_perms
    assert stats.truncated_round is bool(wstats.truncated_round) is False
    # the reference's tensordot branch, and the streaming walk on the same
    # walks: one Monte-Carlo average in three float associations
    plain, _ = gtg_shapley_batched(*port_args, perms, use_kernel=False)
    stream, _ = gtg_shapley_streaming(*port_args, perms)
    np.testing.assert_allclose(plain.numpy(), got.numpy(), atol=1e-6)
    np.testing.assert_allclose(stream.numpy(), got.numpy(), atol=1e-6)


def test_dense_sv_truncated_round_matches_reference():
    m = 3
    jax_args, port_args = _mlp_case(m)
    key = jax.random.key(1)
    want, wstats = jax_dense(*jax_args, key, n_perms=6, eps=1e9)
    got, stats = gtg_shapley_batched(
        *port_args, _t(jax_draw_perms(key, m, 6), torch.int64), eps=1e9)
    assert stats.truncated_round and bool(wstats.truncated_round)
    assert stats.utility_evals == int(wstats.utility_evals) == 2
    assert stats.iterations == int(wstats.iterations) == 0
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ----------------------------------------------------- batched ClientUpdate --
def test_batched_client_update_freezes_finished_stragglers():
    """Each of the M batched clients equals the loop engine's client_update
    with its own budget E_k: a client past E_k * B steps keeps its params
    (and its momentum, or its later steps would drift)."""
    model = make_mlp(784, (16,), 10)
    ccfg = ClientConfig(epochs=3, batches_per_epoch=2, batch_size=8,
                        prox_mu=0.1)
    gen = torch.Generator().manual_seed(0)
    params = model.init(gen, torch.device("cpu"))
    m, cap = 4, 20
    xs = torch.randn((m, cap, 784), generator=gen)
    ys = torch.randint(0, 10, (m, cap), generator=gen)
    epochs_k = np.array([3, 1, 2, 3], np.int32)
    sigma = torch.tensor([0.0, 0.05, 0.0, 0.01])
    idx = torch.randint(0, cap, (m, 6, 8), generator=gen)
    shapes = [tuple(p.shape) for p in tree_leaves(params)]
    noise = [torch.randn((m,) + s, generator=gen) for s in shapes]
    got = batched_client_update(model, ccfg, params, xs, ys, epochs_k, sigma,
                                idx, noise)
    for i in range(m):
        want = client_update(model, ccfg, params, xs[i], ys[i],
                             int(epochs_k[i]), float(sigma[i]), idx[i],
                             [n[i] for n in noise])
        for a, b in zip(tree_leaves(got), tree_leaves(want)):
            torch.testing.assert_close(a[i], b, rtol=0, atol=1e-5)
    # the straggler's update really stopped early
    full = client_update(model, ccfg, params, xs[1], ys[1], 3, 0.05, idx[1],
                         [n[1] for n in noise])
    assert not torch.allclose(got["layer0"]["w"][1], full["layer0"]["w"])


@pytest.mark.parametrize("sel", [torch.tensor([5, 2]), np.array([5, 2]),
                                 [5, 2]], ids=["tensor", "numpy", "list"])
def test_cohort_update_gathers_the_cohort(sel, monkeypatch):
    """One cohort_gather call over the four stacks, bitwise the reference's
    cohort_take of each, whatever form the host ids take."""
    import repro_torch.engine.batch_client as bc
    model = make_mlp(784, (16,), 10)
    ccfg = ClientConfig(epochs=1, batches_per_epoch=2, batch_size=4)
    gen = torch.Generator().manual_seed(1)
    params = model.init(gen, torch.device("cpu"))
    n, cap = 6, 10
    xs_all = torch.randn((n, cap, 784), generator=gen)
    xs_all[5, 0, :7] = -0.0
    ys_all = torch.randint(0, 10, (n, cap), generator=gen)
    nv_all = torch.randint(1, cap, (n,), generator=gen)
    sigma_all = torch.rand((n,), generator=gen)
    idx = torch.randint(0, 4, (2, 2, 4), generator=gen)
    noise = [torch.randn((2,) + tuple(p.shape), generator=gen)
             for p in tree_leaves(params)]
    seen = {}

    def spy(model_, ccfg_, params_, xs, ys, epochs_k, sigma_k, *rest, **kw):
        seen.update(xs=xs, ys=ys, sigma=sigma_k)
        return batched_client_update(model_, ccfg_, params_, xs, ys,
                                     epochs_k, sigma_k, *rest, **kw)

    monkeypatch.setattr(bc, "batched_client_update", spy)
    stacked, n_k = cohort_update(model, ccfg, params, xs_all, ys_all, nv_all,
                                 sigma_all, sel, np.array([1, 1]), idx, noise)
    assert n_k.dtype == torch.float32
    ids = jnp.asarray([5, 2])
    for name, got, table in (("xs", seen["xs"], xs_all),
                             ("ys", seen["ys"], ys_all),
                             ("sigma", seen["sigma"], sigma_all),
                             ("nv", n_k.to(nv_all.dtype), nv_all)):
        want = np.asarray(jax_cohort_take(jnp.asarray(table.numpy()), ids))
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want),
                                      err_msg=name)
    want = batched_client_update(model, ccfg, params, xs_all[[5, 2]],
                                 ys_all[[5, 2]], np.array([1, 1]),
                                 sigma_all[[5, 2]], idx, noise)
    for a, b in zip(tree_leaves(stacked), tree_leaves(want)):
        assert torch.equal(a, b)


# ------------------------------------------------------------ whole runs ----
SLICE = dict(n_clients=6, m=3, rounds=4, n_train=600, n_val=100, n_test=100,
             eval_every=2, shapley_max_iters=6, seed=0)
CLIENT = dict(epochs=2, batches_per_epoch=2, batch_size=16)


def _assert_runs_agree(got, want, atol):
    assert len(got.selections) == len(want.selections)
    for a, b in zip(got.selections, want.selections):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert got.upload_bytes == want.upload_bytes
    assert got.download_bytes == want.download_bytes
    assert got.dispatches == want.dispatches
    assert got.shapley_evals == want.shapley_evals
    np.testing.assert_array_equal(got.selection_counts,
                                  np.asarray(want.selection_counts))
    assert [r for r, _ in got.test_acc] == [r for r, _ in want.test_acc]
    np.testing.assert_allclose([a for _, a in got.test_acc],
                               [a for _, a in want.test_acc], atol=atol)
    np.testing.assert_allclose([v for _, v in got.val_loss],
                               [v for _, v in want.val_loss], atol=atol)
    np.testing.assert_allclose(got.sv_final, np.asarray(want.sv_final),
                               atol=atol)
    for a, b in zip(tree_leaves(got.params), jax.tree.leaves(want.params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol)


@pytest.mark.parametrize("engine,over", [
    ("batched", {}),
    ("batched", {"upload_codec": "quant8_topk"}),
    ("batched", {"straggler_frac": 0.5, "privacy_sigma": 0.05}),
    ("batched", {"shapley_impl": "batched"}),
    ("loop", {"shapley_impl": "batched"}),
])
def test_greedyfed_run_matches_reference_engine(engine, over):
    """N=6, M=3, T=4: two round-robin rounds, then two greedy rounds, the
    port's engine against the reference's same engine on its own draws."""
    kw = {**SLICE, **over, "engine": engine}
    jax_model = jax_make_mlp(784, (16,), 10)       # layer0/w: D = 12544
    want = jax_run_federated(JaxFLConfig(client=JaxClientConfig(**CLIENT),
                                         **kw), model=jax_model)
    draws = JaxReplayDraws(kw["seed"], jax_model, kw["rounds"], kw["m"])
    cfg = FLConfig(client=ClientConfig(**CLIENT), **kw)
    if over.get("straggler_frac"):       # the frozen-client rule is exercised
        s = setup_run(cfg, model=make_mlp(784, (16,), 10), device="cpu",
                      draws=draws)
        assert (s.epochs_table < CLIENT["epochs"]).any()
    got = run_federated(cfg, model=make_mlp(784, (16,), 10), device="cpu",
                        draws=draws)
    _assert_runs_agree(got, want, atol=1e-4)
    assert len({tuple(s) for s in got.selections[:2]}) == 2
    if engine == "batched":
        # one call per round plus two evals at rounds 2 and 4
        assert got.dispatches == kw["rounds"] + 4


@pytest.mark.parametrize("over", [
    {}, {"shapley_impl": "batched"}, {"shapley_impl": "serial"},
    {"upload_codec": "quant8"}, {"upload_codec": "topk"},
    {"selector": "power_of_choice"}, {"selector": "fedavg"},
    {"straggler_frac": 0.5, "privacy_sigma": 0.05, "noise_level": 0.01,
     "prox_mu": 0.1},
])
def test_batched_engine_matches_loop_engine(over):
    """The port's two engines on the port's own draws: one seed, one run."""
    over = dict(over)
    client = ClientConfig(**CLIENT, prox_mu=over.pop("prox_mu", 0.0))
    cfg = FLConfig(client=client, **{**SLICE, "rounds": 3, **over})
    model = make_mlp(784, (16,), 10)
    kernels.reset_launches()
    loop = run_federated(cfg, model=model, device="cpu")
    fused = run_federated(dataclasses.replace(cfg, engine="batched"),
                          model=model, device="cpu")
    assert all(v == 0 for v in kernels.LAUNCHES.values())
    for a, b in zip(fused.selections, loop.selections):
        np.testing.assert_array_equal(a, b)
    assert fused.upload_bytes == loop.upload_bytes
    assert fused.download_bytes == loop.download_bytes
    assert fused.shapley_evals == loop.shapley_evals
    # the batched engine trains each client with the loop's own ops, so on
    # one device the runs are bitwise equal (1e-5 would be the bound else)
    np.testing.assert_array_equal(fused.sv_final, loop.sv_final)
    for a, b in zip(tree_leaves(fused.params), tree_leaves(loop.params)):
        assert torch.equal(a, b)
    assert len(fused.round_time_s) == len(fused.shapley_time_s) == 3


def test_round_engine_spec_and_byte_ledger():
    model = make_mlp(784, (16,), 10)
    ccfg = ClientConfig(**CLIENT)
    # the hardened round builds since the faults slice; a bad FaultSpec
    # is refused where the round is made
    with pytest.raises(ValueError, match="rate"):
        make_round_step(model, ccfg, RoundSpec(faults=FaultSpec(rate=2.0)))
    assert callable(make_round_step(model, ccfg, RoundSpec(quarantine=True)))
    with pytest.raises(ValueError, match="shapley_impl"):
        make_round_step(model, ccfg, RoundSpec(shapley_impl="magic"))
    cfg = FLConfig(client=ccfg, engine="batched", upload_codec="quant8_topk",
                   **SLICE)
    s = setup_run(cfg, model=model, device="cpu")
    engine = RoundEngine(model, ccfg, RoundSpec(upload_codec="quant8_topk"),
                         s.xs, s.ys, s.n_valid, s.sigma_k_all, s.x_val,
                         s.y_val, s.draws)
    assert engine.upload_nbytes_per_client(s.params) == \
        codec_nbytes("quant8_topk", s.params) < s.model_bytes
    out = engine.step(s.params, np.array([0, 3, 5]), np.array([2, 1, 2]), 0)
    assert out.utility_evals == 0 and not out.sv_truncated
    assert out.ok.all() and out.quarantined == 0
    assert tuple(out.params["layer0"]["w"].shape) == (784, 16)
    res = run_federated(dataclasses.replace(cfg, rounds=2), model=model,
                        device="cpu")
    assert res.upload_bytes == 2 * cfg.m * codec_nbytes("quant8_topk",
                                                        s.params)


# ------------------------------------------------------- federated/sim.py --
def test_device_selected_round_matches_reference():
    """select -> gather -> train -> aggregate for one fedavg round, on the
    reference's own key split (sel_key, round_key) replayed as draws."""
    from repro.core.selection_jax import (
        DeviceSelectionContext as JaxContext,
    )
    from repro.federated.server import setup_run as jax_setup_run
    from repro.federated.sim import (
        device_selected_round as jax_device_selected_round,
    )
    from repro_torch.core.selection import DeviceSelectionContext
    from repro_torch.federated.sim import device_selected_round

    kw = dict(SLICE, selector="fedavg", privacy_sigma=0.05)
    jax_model = jax_make_mlp(784, (16,), 10)
    jcfg = JaxFLConfig(client=JaxClientConfig(**CLIENT), **kw)
    js = jax_setup_run(jcfg, model=jax_model)
    epochs_all = np.array([2, 1, 2, 2, 1, 2], np.int32)
    key = jax.random.key(3)
    want_sel, want_state, want_params = jax_device_selected_round(
        jax_model, jcfg.client, js.sel_spec, js.params, js.xs, js.ys,
        js.n_valid, jnp.asarray(js.sigma_k_all), jnp.asarray(epochs_all),
        js.sel_state, JaxContext(
            data_fractions=jnp.asarray(js.fractions),
            local_losses=jnp.zeros(6, jnp.float32),
            poc_d=jnp.asarray(0, jnp.int32)), key)

    sel_key, round_key = jax.random.split(key)
    draws = JaxReplayDraws(kw["seed"], jax_model, 1, kw["m"])
    draws.sel_keys = [sel_key]              # the round's own key split
    draws.ckeys = [jax.random.split(round_key, kw["m"] + 1)]
    cfg = FLConfig(client=ClientConfig(**CLIENT), **kw)
    s = setup_run(cfg, model=make_mlp(784, (16,), 10), device="cpu",
                  draws=draws)
    sel, state, new_params = device_selected_round(
        s.model, cfg.client, s.sel_spec, s.params, s.xs, s.ys, s.n_valid,
        torch.as_tensor(s.sigma_k_all), epochs_all, s.sel_state,
        DeviceSelectionContext(data_fractions=_t(s.fractions),
                               local_losses=torch.zeros(6), poc_d=0),
        draws, 0)
    np.testing.assert_array_equal(sel.numpy(), np.asarray(want_sel))
    assert int(state.round) == int(want_state.round) == 1
    np.testing.assert_array_equal(state.valuation.counts.numpy(),
                                  np.asarray(want_state.valuation.counts))
    for a, b in zip(tree_leaves(new_params), jax.tree.leaves(want_params)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    assert not torch.equal(new_params["layer0"]["w"], s.params["layer0"]["w"])


def test_parallel_client_round_is_the_batched_update_and_its_average():
    from repro_torch.core.aggregation import (
        normalized_weights, weighted_average,
    )
    from repro_torch.federated.sim import parallel_client_round
    model = make_mlp(784, (16,), 10)
    ccfg = ClientConfig(epochs=1, batches_per_epoch=2, batch_size=4)
    gen = torch.Generator().manual_seed(2)
    params = model.init(gen, torch.device("cpu"))
    xs = torch.randn((3, 10, 784), generator=gen)
    ys = torch.randint(0, 10, (3, 10), generator=gen)
    nv = torch.tensor([10, 4, 7])
    idx = torch.randint(0, 4, (3, 2, 4), generator=gen)
    noise = [torch.randn((3,) + tuple(p.shape), generator=gen)
             for p in tree_leaves(params)]
    sigma = torch.tensor([0.0, 0.1, 0.0])
    stacked, new_params = parallel_client_round(
        model, ccfg, params, xs, ys, nv, np.array([1, 1, 1]), sigma, idx,
        noise)
    want = batched_client_update(model, ccfg, params, xs, ys,
                                 np.array([1, 1, 1]), sigma, idx, noise)
    avg = weighted_average(want, normalized_weights(nv.float()))
    for a, b in zip(tree_leaves(stacked) + tree_leaves(new_params),
                    tree_leaves(want) + tree_leaves(avg)):
        assert torch.equal(a, b)
