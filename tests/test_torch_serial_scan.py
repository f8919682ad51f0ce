"""The serial GTG-Shapley estimator (Alg. 2) under engine="scan", on the
CPU: its device form, the captured round that holds it, and the runs.

On the CPU `graph_flow.while_` / `if_` run their masked unroll (every step
evaluated, kept or discarded by `torch.where`), the values a card's WHILE
and IF nodes give.  Tolerances: the device form against the host loop
`gtg_shapley` is bitwise (the same float32 operations in the same order,
the same utility calls); the scan against the batched engine is bitwise
(the same draws, the same ops); a segmented run and a grid cell equal
their whole solo run bitwise; against the reference's scan (the port fed
the reference's draws through `JaxReplayDraws`) selections, bytes and
evaluation counts are equal and floats agree at 1e-4, the bound of
`test_torch_scan.py::test_scan_matches_reference_scan`.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.federated.client import ClientConfig as JaxClientConfig
from repro.federated.server import FLConfig as JaxFLConfig
from repro.federated.server import run_federated as jax_run_federated
from repro.models.mlp_cnn import make_mlp as jax_make_mlp
from repro_torch.core.shapley import (
    gtg_shapley, gtg_shapley_device, permutation_block,
)
from repro_torch.engine import graph_flow
from repro_torch.engine.round_engine import RoundSpec, round_plan
from repro_torch.faults import FaultSpec
from repro_torch.federated.client import ClientConfig
from repro_torch.federated.server import FLConfig, run_federated
from repro_torch.grid import GridCell, GridSpec, run_grid
from repro_torch.models.mlp_cnn import make_mlp
from repro_torch.tree import tree_leaves
from test_torch_engine import _mlp_case
from test_torch_server import JaxReplayDraws

SLICE = dict(n_clients=6, m=3, rounds=4, n_train=600, n_val=100, n_test=100,
             eval_every=2, shapley_max_iters=6, seed=0,
             shapley_impl="serial")
CLIENT = dict(epochs=2, batches_per_epoch=2, batch_size=16)
MODEL = make_mlp(784, (16,), 10)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Six test files run at once: one intra-op thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(**over):
    return FLConfig(client=ClientConfig(**CLIENT), **{**SLICE, **over})


def _assert_bitwise(got, want):
    assert len(got.selections) == len(want.selections)
    for a, b in zip(got.selections, want.selections):
        np.testing.assert_array_equal(a, b)
    assert got.upload_bytes == want.upload_bytes
    assert got.download_bytes == want.download_bytes
    assert got.shapley_evals == want.shapley_evals
    assert got.round_shapley_evals == want.round_shapley_evals
    assert got.round_shapley_iterations == want.round_shapley_iterations
    assert got.quarantined_total == want.quarantined_total
    assert got.test_acc == want.test_acc and got.val_loss == want.val_loss
    np.testing.assert_array_equal(got.sv_final, want.sv_final)
    for a, b in zip(tree_leaves(got.params), tree_leaves(want.params)):
        assert torch.equal(a, b)


# ------------------------------------------------------- the device form --
@pytest.mark.parametrize("eps,tol,max_iters", [
    (1e-4, 0.05, 12), (1e-2, 0.05, 12), (0.5, 0.05, 12), (1e9, 0.05, 12),
    (1e-4, 0.0, 5)])
def test_device_form_is_bitwise_the_host_loop(eps, tol, max_iters):
    """SVs and every stat equal bit for bit; tolerance 0 never converges,
    so that case runs all max_iters MC rounds."""
    _, (stacked, n_k, w_prev, util, _) = _mlp_case(3, seed=1)
    walks = permutation_block(torch.Generator().manual_seed(3), 3, max_iters)
    kw = dict(eps=eps, max_iters=max_iters, convergence_tol=tol)
    host_sv, host = gtg_shapley(stacked, n_k, w_prev, util, walks, **kw)
    dev_sv, dev = gtg_shapley_device(stacked, n_k, w_prev, util, walks, **kw)
    assert torch.equal(dev_sv, host_sv)
    assert isinstance(dev.iterations, torch.Tensor)
    assert int(dev.iterations) == host.iterations
    assert int(dev.utility_evals) == host.utility_evals
    assert float(dev.v0) == host.v0 and float(dev.vM) == host.vM
    assert bool(dev.truncated_round) == host.truncated_round == (eps > 1)
    if eps > 1:
        assert host.iterations == 0 and host.utility_evals == 2
    if tol == 0.0:
        assert host.iterations == max_iters
    elif eps < 1:
        assert 0 < host.iterations < max_iters
    if eps == 0.5:    # within-round truncation skipped some evaluations
        assert host.utility_evals < host.iterations * 9 + 2


def test_permutation_block_rows_are_walks_led_by_their_slot():
    block = permutation_block(torch.Generator().manual_seed(0), 5, 7)
    assert block.shape == (35, 5) and block.dtype == torch.int64
    for i, row in enumerate(block.tolist()):
        assert sorted(row) == list(range(5)) and row[0] == i % 5
    one = permutation_block(torch.Generator().manual_seed(0), 1, 3)
    assert one.tolist() == [[0], [0], [0]]


def test_round_plan_draws_the_walk_block():
    plan = round_plan(RoundSpec(needs_sv=True, shapley_impl="serial",
                                shapley_max_iters=7), ClientConfig(), (),
                      6, 3, {"w": torch.zeros(2)}, np.full(6, 10))
    assert plan.walk_block and plan.n_perms == 21
    stream = round_plan(RoundSpec(needs_sv=True, shapley_max_iters=7),
                        ClientConfig(), (), 6, 3, {"w": torch.zeros(2)},
                        np.full(6, 10))
    assert not stream.walk_block and stream.n_perms == 7


def test_graph_flow_masked_unroll():
    """Off the card `while_` runs max_passes masked passes and `if_` its
    body with the result kept only where the flag holds."""
    x = torch.zeros(())
    go = torch.ones((), dtype=torch.bool)

    def body():
        x.add_(1.0)
        go.copy_(x < 3.0)

    graph_flow.while_(go, body, (x,), max_passes=10)
    assert float(x) == 3.0 and not bool(go)
    graph_flow.while_(torch.zeros((), dtype=torch.bool), body, (x,), 4)
    assert float(x) == 3.0
    y = torch.full((), 5.0)
    graph_flow.if_(torch.zeros((), dtype=torch.bool),
                   lambda: y.copy_(y * 2), (y,))
    assert float(y) == 5.0
    graph_flow.if_(torch.ones((), dtype=torch.bool),
                   lambda: y.copy_(y * 2), (y,))
    assert float(y) == 10.0
    with graph_flow.eager_passes(1):
        x.zero_()
        go.fill_(True)
        graph_flow.while_(go, body, (x,), max_passes=10)
    assert float(x) == 1.0
    with pytest.raises(ValueError, match="bool"):
        graph_flow.if_(torch.ones(()), lambda: None, ())


# ------------------------------------------------------------ whole runs --
@pytest.mark.parametrize("over", [
    {"upload_codec": "quant8_topk"},
    {"selector": "power_of_choice"},
    {"upload_codec": "quant8_topk", "quarantine": True,
     "faults": FaultSpec(rate=0.4, kinds=("nan", "sign_flip", "crash"))}])
def test_serial_scan_is_bitwise_the_batched_engine(over):
    cfg = _cfg(engine="scan", **over)
    scan = run_federated(cfg, model=MODEL, device="cpu")
    batched = run_federated(dataclasses.replace(cfg, engine="batched"),
                            model=MODEL, device="cpu")
    _assert_bitwise(scan, batched)
    valued = "selector" not in over     # power_of_choice values no one
    assert sum(scan.round_shapley_evals) == scan.shapley_evals
    assert (scan.shapley_evals > 0) == valued
    assert all(0 <= n <= SLICE["shapley_max_iters"]
               for n in scan.round_shapley_iterations)
    if "faults" in over:
        assert scan.quarantined_total > 0


def test_serial_scan_segments_equal_the_whole_run():
    cfg = _cfg(engine="scan", upload_codec="quant8_topk")
    whole = run_federated(cfg, model=MODEL, device="cpu")
    seg = run_federated(cfg, model=MODEL, device="cpu", rounds_per_segment=2)
    _assert_bitwise(seg, whole)


def test_serial_grid_cell_is_bitwise_its_solo_scan_run():
    spec = GridSpec(_cfg(engine="scan"), (GridCell("greedyfed", 0),
                                          GridCell("greedyfed", 1),
                                          GridCell("fedavg", 0)))
    grid = run_grid(spec, model=MODEL, device="cpu", rounds_per_segment=2)
    for cell, got in zip(spec.cells, grid.results):
        solo = run_federated(cell.config(spec.base), model=MODEL,
                             device="cpu")
        _assert_bitwise(got, solo)


def test_serial_scan_matches_the_reference_scan():
    """The port's serial scan on the reference's draws (its MC rounds'
    key splits as one walk block) against the reference's engine="scan"
    with shapley_impl="serial"."""
    kw = {**SLICE, "engine": "scan", "upload_codec": "quant8_topk"}
    jax_model = jax_make_mlp(784, (16,), 10)
    want = jax_run_federated(JaxFLConfig(client=JaxClientConfig(**CLIENT),
                                         **kw), model=jax_model)
    got = run_federated(FLConfig(client=ClientConfig(**CLIENT), **kw),
                        model=make_mlp(784, (16,), 10), device="cpu",
                        draws=JaxReplayDraws(kw["seed"], jax_model,
                                             kw["rounds"], kw["m"]))
    for a, b in zip(got.selections, want.selections):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert got.upload_bytes == want.upload_bytes
    assert got.download_bytes == want.download_bytes
    assert got.shapley_evals == want.shapley_evals
    assert [r for r, _ in got.test_acc] == [r for r, _ in want.test_acc]
    np.testing.assert_allclose([a for _, a in got.test_acc],
                               [a for _, a in want.test_acc], atol=1e-4)
    np.testing.assert_allclose([v for _, v in got.val_loss],
                               [v for _, v in want.val_loss], atol=1e-4)
    np.testing.assert_allclose(got.sv_final, np.asarray(want.sv_final),
                               atol=1e-4)
    for a, b in zip(tree_leaves(got.params), jax.tree.leaves(want.params)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)
