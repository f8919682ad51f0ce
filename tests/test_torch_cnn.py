"""The paper's CIFAR-10 task (`dataset="cifar10"`, the CNN) in the port,
against the reference and across the port's three engines.

A narrow CNN on cifar10-shaped data, `make_cnn((32, 32, 3), channels=(4,
8), dense=16)` in both packages: the full-width CNN's shapes but for the
channel counts (the full width runs on the card, `chip_smoke.py` phase
25).  The port's loop and batched engines against the reference's loop
engine on the reference's own draws (`JaxReplayDraws`): selections and
byte counts equal, params, accuracies and SVs at 1e-4, the bound
`test_torch_server.py` holds the MLP to.  The port's loop, batched and
scan engines bit for bit, with and without the quant8_topk codec.  The
CNN's `apply_batched` (the utility's forward over B models on one input)
against the per-model `apply` and `jax.vmap` of the reference's `apply`
at 1e-5.  The two example counterparts import neither JAX nor the
reference.
"""
import ast
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.federated.client import ClientConfig as JaxClientConfig
from repro.federated.server import FLConfig as JaxFLConfig
from repro.federated.server import run_federated as jax_run_federated
from repro.models.mlp_cnn import make_cnn as jax_make_cnn
from repro_torch.core.aggregation import tree_stack
from repro_torch.device import resolve_device
from repro_torch.federated.client import ClientConfig
from repro_torch.federated.server import FLConfig, run_federated
from repro_torch.interop import params_from_numpy
from repro_torch.models.mlp_cnn import make_cnn
from repro_torch.tree import tree_leaves
from test_torch_server import SLICE, JaxReplayDraws

ROOT = Path(__file__).resolve().parents[1]
NARROW = dict(input_shape=(32, 32, 3), channels=(4, 8), dense=16)
CLIENT = dict(epochs=2, batches_per_epoch=2, batch_size=16)
CIFAR = dict(SLICE, dataset="cifar10")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs six test files at once; at these small sizes torch's
    intra-op threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(**over):
    return FLConfig(client=ClientConfig(**CLIENT), **{**CIFAR, **over})


@pytest.fixture(scope="module")
def reference_run():
    """The reference's loop engine on the narrow CNN (its draws replayed
    into the port's runs below)."""
    jax_model = jax_make_cnn(**NARROW)
    want = jax_run_federated(JaxFLConfig(client=JaxClientConfig(**CLIENT),
                                         **CIFAR), model=jax_model)
    return jax_model, want


@pytest.mark.parametrize("engine", ["loop", "batched"])
def test_cnn_run_matches_reference(reference_run, engine):
    """N=6, M=3, T=4 on synthetic CIFAR-10: two round-robin rounds, then
    two greedy rounds, each valued by GTG-Shapley over the CNN."""
    jax_model, want = reference_run
    draws = JaxReplayDraws(CIFAR["seed"], jax_model, CIFAR["rounds"],
                           CIFAR["m"])
    got = run_federated(_cfg(engine=engine), model=make_cnn(**NARROW),
                        device="cpu", draws=draws)
    assert len(got.selections) == len(want.selections) == CIFAR["rounds"]
    for a, b in zip(got.selections, want.selections):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert got.upload_bytes == want.upload_bytes
    assert got.download_bytes == want.download_bytes
    assert got.shapley_evals == want.shapley_evals
    np.testing.assert_array_equal(got.selection_counts,
                                  np.asarray(want.selection_counts))
    assert [r for r, _ in got.test_acc] == [r for r, _ in want.test_acc]
    np.testing.assert_allclose([a for _, a in got.test_acc],
                               [a for _, a in want.test_acc], atol=1e-4)
    np.testing.assert_allclose([v for _, v in got.val_loss],
                               [v for _, v in want.val_loss], atol=1e-4)
    np.testing.assert_allclose(got.sv_final, np.asarray(want.sv_final),
                               atol=1e-4)
    assert np.abs(got.sv_final).max() > 0       # the rounds were valued
    for a, b in zip(tree_leaves(got.params), jax.tree.leaves(want.params)):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)


@pytest.mark.parametrize("codec", ["identity", "quant8_topk"])
def test_cnn_engines_bitwise(codec):
    """Loop == batched == scan bit for bit on the CNN: selections, bytes,
    eval history, SVs and params."""
    model = make_cnn(**NARROW)
    runs = {engine: run_federated(_cfg(engine=engine, upload_codec=codec),
                                  model=model, device="cpu")
            for engine in ("loop", "batched", "scan")}
    want = runs["loop"]
    for engine in ("batched", "scan"):
        got = runs[engine]
        for a, b in zip(got.selections, want.selections):
            np.testing.assert_array_equal(a, b)
        assert got.upload_bytes == want.upload_bytes
        assert got.download_bytes == want.download_bytes
        assert got.shapley_evals == want.shapley_evals
        assert got.test_acc == want.test_acc
        assert got.val_loss == want.val_loss
        np.testing.assert_array_equal(got.sv_final, want.sv_final)
        for a, b in zip(tree_leaves(got.params), tree_leaves(want.params)):
            assert torch.equal(a, b)
    assert np.abs(want.sv_final).max() > 0


@pytest.mark.parametrize("n_models", [1, 7])
def test_cnn_apply_batched_matches_apply_and_vmap(n_models):
    """The utility's forward over B models on one shared input against
    each model's `apply` and the reference's vmapped `apply` (the
    reference's batched utility, `shapley_batched.py`), at 1e-5."""
    jm, tm = jax_make_cnn(**NARROW), make_cnn(**NARROW)
    keys = jax.random.split(jax.random.key(5), n_models)
    jax_ps = [jm.init(k) for k in keys]
    ps = [params_from_numpy(jax.tree.map(np.asarray, p)) for p in jax_ps]
    x = np.random.default_rng(6).standard_normal((9, 32, 32, 3)).astype(
        np.float32)
    got = tm.apply_batched(tree_stack(ps), torch.from_numpy(x))
    assert tuple(got.shape) == (n_models, 9, 10)
    for b, p in enumerate(ps):
        torch.testing.assert_close(got[b], tm.apply(p, torch.from_numpy(x)),
                                   atol=1e-5, rtol=0)
    stacked = jax.tree.map(lambda *t: jnp.stack(t), *jax_ps)
    want = jax.vmap(jm.apply, in_axes=(0, None))(stacked, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def test_resolve_device_makes_cudnn_deterministic():
    """Every entry point resolves its device first, which turns TF32 off
    and cuDNN's deterministic algorithms on, without autotuning."""
    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.benchmark = True
    assert resolve_device("cpu") == torch.device("cpu")
    assert torch.backends.cudnn.deterministic
    assert not torch.backends.cudnn.benchmark
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32


@pytest.mark.parametrize("example", ["quickstart_torch.py",
                                     "heterogeneity_sweep_torch.py"])
def test_example_imports_neither_jax_nor_the_reference(example):
    """The examples' counterparts import only the port (and the standard
    library), and take the same configs as the reference's examples."""
    path = ROOT / "examples" / example
    tree = ast.parse(path.read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            roots.add((node.module or "").split(".")[0])
    assert "repro_torch" in roots
    assert not roots & {"jax", "jaxlib", "repro", "flax"}
    ref = (ROOT / "examples" / example.replace("_torch", "")).read_text()
    for line in ("n_train=2500, n_val=300, n_test=500",
                 "client=ClientConfig(epochs=3, batches_per_epoch=3, "
                 "batch_size=32)"):
        assert line in ref and line in path.read_text()
