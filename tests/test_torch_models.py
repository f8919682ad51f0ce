"""The port's models, client update, optimizer, aggregation and valuation
against the reference's, on the same numpy-seeded inputs and carried-over
params.

Tolerances: forward passes at 1e-5 (f32 matmul sums in another order);
client updates at 1e-5 after a few SGD steps (gradients agree to f32
rounding); reductions over the client axis at 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as jagg
from repro.core import valuation as jval
from repro.federated.client import ClientConfig as JaxClientConfig
from repro.federated.client import client_update as jax_client_update
from repro.federated.client import local_loss as jax_local_loss
from repro.models import mlp_cnn as jmodels
from repro.optim.sgd import sgd_init as jax_sgd_init
from repro.optim.sgd import sgd_step as jax_sgd_step
from repro_torch.core import aggregation as agg
from repro_torch.core import valuation as val
from repro_torch.federated.client import ClientConfig, client_update, local_loss
from repro_torch.interop import params_from_numpy, params_to_numpy
from repro_torch.models import mlp_cnn as models
from repro_torch.optim.sgd import sgd_init, sgd_step
from repro_torch.tree import tree_leaves, tree_map, tree_paths


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_tree_close(got, want, atol):
    want = _np(want)
    assert tree_paths(got) == tree_paths(want)
    for path, a, b in zip(tree_paths(got), tree_leaves(got),
                          tree_leaves(want)):
        np.testing.assert_allclose(a.detach().numpy(), b, atol=atol, rtol=0,
                                   err_msg=path)


def _carry(jax_model, seed):
    p = jax_model.init(jax.random.key(seed))
    return p, params_from_numpy(_np(p))


@pytest.mark.parametrize("kind", ["mlp", "cnn"])
def test_logits_loss_accuracy_match(kind):
    rng = np.random.default_rng(0)
    if kind == "mlp":
        jm, tm = jmodels.make_mlp(), models.make_mlp()
        x = rng.standard_normal((16, 784)).astype(np.float32)
    else:
        shape = (8, 8, 3)
        jm = jmodels.make_cnn(shape, channels=(4, 8), dense=16)
        tm = models.make_cnn(shape, channels=(4, 8), dense=16)
        x = rng.standard_normal((6,) + shape).astype(np.float32)
    y = rng.integers(0, 10, size=x.shape[0]).astype(np.int32)
    jp, tp = _carry(jm, 1)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    np.testing.assert_allclose(tm.apply(tp, xt).numpy(),
                               np.asarray(jm.apply(jp, jnp.asarray(x))),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(float(tm.loss(tp, xt, yt)),
                               float(jm.loss(jp, jnp.asarray(x),
                                             jnp.asarray(y))), rtol=1e-5)
    assert float(tm.accuracy(tp, xt, yt)) == float(
        jm.accuracy(jp, jnp.asarray(x), jnp.asarray(y)))


@pytest.mark.parametrize("kind", ["mlp", "cnn"])
def test_init_shapes_match_reference(kind):
    jm = jmodels.make_mlp() if kind == "mlp" else jmodels.make_cnn()
    tm = models.make_mlp() if kind == "mlp" else models.make_cnn()
    gen = torch.Generator().manual_seed(0)
    got = tm.init(gen, torch.device("cpu"))
    want = jax.eval_shape(jm.init, jax.random.key(0))
    assert tree_paths(got) == tree_paths(_np(jax.tree.map(
        lambda s: np.zeros((), s.dtype), want)))
    for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
        assert tuple(a.shape) == b.shape and a.dtype == torch.float32
    if kind == "mlp":
        assert sum(a.numel() for a in tree_leaves(got)) == 178110


@pytest.mark.parametrize("kind", ["mlp", "cnn"])
def test_apply_batched_equals_per_model_apply(kind):
    rng = np.random.default_rng(2)
    if kind == "mlp":
        tm = models.make_mlp(784, (16,), 10)
        x = torch.from_numpy(rng.standard_normal((12, 784)).astype(np.float32))
    else:
        tm = models.make_cnn((8, 8, 3), channels=(4,), dense=8)
        x = torch.from_numpy(rng.standard_normal((5, 8, 8, 3)).astype(np.float32))
    gen = torch.Generator().manual_seed(3)
    ps = [tm.init(gen, torch.device("cpu")) for _ in range(4)]
    got = tm.apply_batched(agg.tree_stack(ps), x)
    for b, p in enumerate(ps):
        torch.testing.assert_close(got[b], tm.apply(p, x), atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("prox_mu,sigma,epochs_k", [(0.0, 0.0, 2),
                                                   (0.1, 0.05, 1),
                                                   (0.0, 0.02, 0)])
def test_client_update_with_replayed_draws(prox_mu, sigma, epochs_k):
    jm, tm = jmodels.make_mlp(784, (16,), 10), models.make_mlp(784, (16,), 10)
    jcfg = JaxClientConfig(epochs=2, batches_per_epoch=3, batch_size=8,
                           prox_mu=prox_mu)
    tcfg = ClientConfig(epochs=2, batches_per_epoch=3, batch_size=8,
                        prox_mu=prox_mu)
    rng = np.random.default_rng(4)
    cap, n_valid = 40, 31
    x = rng.standard_normal((cap, 784)).astype(np.float32)
    y = rng.integers(0, 10, size=cap).astype(np.int32)
    jp, tp = _carry(jm, 5)
    key = jax.random.key(6)
    want = jax_client_update(jm, jcfg, jp, jnp.asarray(x), jnp.asarray(y),
                             jnp.asarray(n_valid), jnp.asarray(epochs_k),
                             jnp.asarray(sigma, jnp.float32), key)
    # replay the reference's draws (client.py: idx, then per-leaf noise)
    idx_key, noise_key = jax.random.split(key)
    idx = jax.random.randint(idx_key, (6, 8), 0, n_valid)
    shapes = [tuple(a.shape) for a in tree_leaves(tp)]
    noise = [torch.tensor(np.asarray(jax.random.normal(k, s, jnp.float32)))
             for k, s in zip(jax.random.split(noise_key, len(shapes)), shapes)]
    got = client_update(tm, tcfg, tp, torch.from_numpy(x), torch.from_numpy(y),
                        epochs_k, sigma, torch.tensor(np.asarray(idx)).long(),
                        noise)
    _assert_tree_close(got, want, atol=1e-5)


def test_local_loss_matches_reference():
    jm, tm = jmodels.make_mlp(784, (16,), 10), models.make_mlp(784, (16,), 10)
    rng = np.random.default_rng(8)
    xs = rng.standard_normal((4, 20, 784)).astype(np.float32)
    ys = rng.integers(0, 10, size=(4, 20)).astype(np.int32)
    nv = np.array([20, 3, 0, 11], np.int32)
    jp, tp = _carry(jm, 9)
    want = jax.vmap(lambda x, y, n: jax_local_loss(jm, jp, x, y, n))(
        jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(nv))
    got = local_loss(tm, tp, torch.from_numpy(xs), torch.from_numpy(ys),
                     torch.from_numpy(nv))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_sgd_step_matches_reference():
    rng = np.random.default_rng(10)
    tree = {"a": {"w": rng.standard_normal((3, 4)).astype(np.float32)},
            "b": rng.standard_normal((5,)).astype(np.float32)}
    grads = jax.tree.map(lambda a: (a * 0.3 + 1).astype(np.float32), tree)
    js, ts = jax_sgd_init(tree), sgd_init(params_from_numpy(tree))
    jp, tp = tree, params_from_numpy(tree)
    for _ in range(3):
        jp, js = jax_sgd_step(grads, js, jp, lr=0.01, momentum=0.5)
        tp, ts = sgd_step(params_from_numpy(grads), ts, tp, lr=0.01,
                          momentum=0.5)
    for a, b in zip(tree_leaves(params_to_numpy(tp)), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_aggregation_matches_reference():
    rng = np.random.default_rng(12)
    m = 4
    models_np = [{"l": {"w": rng.standard_normal((6, 3)).astype(np.float32),
                        "b": rng.standard_normal((3,)).astype(np.float32)}}
                 for _ in range(m)]
    n_k = np.array([3.0, 0.0, 7.0, 12.0], np.float32)
    mask = np.array([1.0, 1.0, 0.0, 1.0], np.float32)
    jstack = jagg.tree_stack([jax.tree.map(jnp.asarray, t) for t in models_np])
    tstack = agg.tree_stack([params_from_numpy(t) for t in models_np])
    np.testing.assert_allclose(agg.normalized_weights(torch.from_numpy(n_k),
                                                      torch.from_numpy(mask)),
                               np.asarray(jagg.normalized_weights(
                                   jnp.asarray(n_k), jnp.asarray(mask))),
                               atol=1e-7)
    assert float(agg.normalized_weights(torch.zeros(3)).sum()) == 0.0
    _assert_tree_close(agg.subset_average(tstack, torch.from_numpy(n_k),
                                          torch.from_numpy(mask)),
                       jagg.subset_average(jstack, jnp.asarray(n_k),
                                           jnp.asarray(mask)), atol=1e-6)
    _assert_tree_close(agg.model_average([params_from_numpy(t)
                                          for t in models_np], n_k),
                       jagg.model_average([jax.tree.map(jnp.asarray, t)
                                           for t in models_np],
                                          jnp.asarray(n_k)), atol=1e-6)
    a, b = params_from_numpy(models_np[0]), params_from_numpy(models_np[1])
    ja, jb = models_np[0], models_np[1]
    _assert_tree_close(agg.tree_add(a, b), jagg.tree_add(ja, jb), atol=0)
    _assert_tree_close(agg.tree_sub(a, b), jagg.tree_sub(ja, jb), atol=0)
    _assert_tree_close(agg.tree_scale(a, 0.5), jagg.tree_scale(ja, 0.5),
                       atol=0)
    np.testing.assert_allclose(float(agg.tree_sq_norm(a)),
                               float(jagg.tree_sq_norm(ja)), rtol=1e-6)
    assert agg.tree_size(a) == jagg.tree_size(ja) == 21
    for got, want in zip(agg.tree_unstack(tstack, m),
                         jagg.tree_unstack(jstack, m)):
        _assert_tree_close(got, want, atol=0)
    assert all(x.dtype == torch.bfloat16 for x in
               tree_leaves(agg.tree_cast(a, torch.bfloat16)))
    assert all(float(x.abs().sum()) == 0 for x in
               tree_leaves(agg.tree_zeros_like(a)))


@pytest.mark.parametrize("mode", ["mean", "exponential"])
def test_valuation_updates_match_reference(mode):
    rng = np.random.default_rng(13)
    js, ts = jval.init_valuation(7), val.init_valuation(7)
    for _ in range(5):
        sel = rng.choice(7, 3, replace=False)
        sv = rng.standard_normal(3).astype(np.float32)
        js = jval.update_valuation(js, jnp.asarray(sel), jnp.asarray(sv),
                                   mode=mode, alpha=0.3)
        ts = val.update_valuation(ts, torch.from_numpy(sel),
                                  torch.from_numpy(sv), mode=mode, alpha=0.3)
    np.testing.assert_allclose(ts.sv.numpy(), np.asarray(js.sv), atol=1e-7)
    np.testing.assert_array_equal(ts.counts.numpy(), np.asarray(js.counts))
    np.testing.assert_array_equal(ts.initialised.numpy(),
                                  np.asarray(js.initialised))
    with pytest.raises(ValueError):
        val.update_valuation(ts, torch.tensor([0]), torch.tensor([1.0]),
                             mode="median")


def test_interop_round_trip():
    tree = {"layer0": {"w": np.ones((2, 3), np.float32),
                       "b": np.zeros(3, np.float32)}}
    back = params_to_numpy(params_from_numpy(tree))
    assert tree_paths(back) == ["layer0/b", "layer0/w"]
    np.testing.assert_array_equal(back["layer0"]["w"], tree["layer0"]["w"])
    same = tree_map(lambda a, b: a is b, tree, tree)
    assert all(tree_leaves(same))
