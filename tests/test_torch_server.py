"""The whole slice: the port's GreedyFed loop run against the reference's.

Both packages run the same config on the same data; the port receives the
reference's own random draws through `RunDraws` (`JaxReplayDraws` walks the
reference's key tree: server.py's init/select/round keys, client.py's
index and noise keys, shapley_batched.py's walk keys).  Selections and byte
counts must be equal; params, the accuracy curve and the cumulative SVs
must agree at 1e-4 (f32 rounding of 4 rounds of local SGD, averaging and
Shapley walks, taken in other orders by the two frameworks).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.shapley import _permutation_batch as jax_perm_batch
from repro.core.shapley_batched import _draw_perms as jax_draw_perms
from repro.federated.client import ClientConfig as JaxClientConfig
from repro.federated.server import FLConfig as JaxFLConfig
from repro.federated.server import run_centralized as jax_run_centralized
from repro.federated.server import run_federated as jax_run_federated
from repro.models.mlp_cnn import make_mlp as jax_make_mlp
from repro_torch import kernels
from repro_torch.core.selection import SelectionDraw
from repro_torch.faults import FaultSpec
from repro_torch.federated.client import ClientConfig
from repro_torch.federated.draws import RoundDraws
from repro_torch.federated.server import (
    FLConfig, run_centralized, run_federated, run_federated_replicated,
)
from repro_torch.interop import params_from_numpy
from repro_torch.models.mlp_cnn import make_mlp
from repro_torch.tree import tree_leaves


def _t(a):
    return torch.tensor(np.asarray(a))


def jax_walk_block(key, m, max_iters):
    """The reference serial estimator's walks as one (max_iters * M, M)
    block: MC round tau walks `_permutation_batch` of the tau-th split of
    its key (`gtg_shapley.mc_round`)."""
    batches = []
    for _ in range(max_iters):
        key, sub = jax.random.split(key)
        batches.append(np.asarray(jax_perm_batch(sub, m)))
    return torch.from_numpy(np.concatenate(batches)).long()


class JaxReplayDraws:
    """`RunDraws` that replays the reference loop engine's key tree (its
    batched and scan engines split the same keys).  A slot's minibatch
    table depends on the client it holds, so each slot gets every client's
    table and the port picks the selected client's, on the device."""

    def __init__(self, seed, jax_model, rounds, m):
        key = jax.random.key(seed)
        key, init_key = jax.random.split(key)              # server.py:281
        self._init = jax_model.init(init_key)
        self.sel_keys, self.ckeys = [], []
        for _ in range(rounds):
            key, sel_key, round_key = jax.random.split(key, 3)   # :478
            self.sel_keys.append(sel_key)
            self.ckeys.append(jax.random.split(round_key, m + 1))  # :521

    def init_params(self, model):
        return params_from_numpy(jax.tree.map(np.asarray, self._init))

    def round(self, t, plan):
        sel_key, choice, gumbel = self.sel_keys[t], None, None
        if "choice" in plan.selection:
            choice = _t(jax.random.choice(sel_key, plan.n_clients,
                                          (plan.m,), replace=False))
        if "gumbel" in plan.selection:
            gumbel = _t(jax.random.gumbel(sel_key, (plan.n_clients,),
                                          jnp.float32))
        slots = [_slot_draws(self.ckeys[t][i], plan) for i in range(plan.m)]
        walks = None
        if plan.walk_block:
            walks = jax_walk_block(self.ckeys[t][-1], plan.m,
                                   plan.n_perms // plan.m)
        elif plan.n_perms:
            walks = _t(jax_draw_perms(self.ckeys[t][-1], plan.m,
                                      plan.n_perms)).long()
        return RoundDraws(SelectionDraw(choice, gumbel),
                          torch.stack([tables for tables, _ in slots]),
                          [torch.stack(leaves) for leaves in
                           zip(*(noise for _, noise in slots))], walks)


def _slot_draws(key, plan):
    """client.py:52-55 and 75-78 for one cohort slot: the index table for
    every client's n_valid, (N, E*B, batch), then the per-leaf noise."""
    idx_key, noise_key = jax.random.split(key)
    tables = {n: _t(jax.random.randint(idx_key, (plan.n_steps,
                                                 plan.batch_size), 0,
                                       max(n, 1))).long()
              for n in set(plan.n_valid)}
    noise = [_t(jax.random.normal(k, s, jnp.float32)) for k, s in
             zip(jax.random.split(noise_key, len(plan.shapes)), plan.shapes)]
    return torch.stack([tables[n] for n in plan.n_valid]), noise


SLICE = dict(n_clients=6, m=3, rounds=4, n_train=600, n_val=100, n_test=100,
             eval_every=2, shapley_max_iters=6, seed=0)
CLIENT = dict(epochs=2, batches_per_epoch=2, batch_size=16)


def _run_both(**over):
    kw = {**SLICE, **over}
    jax_model = jax_make_mlp(784, (16,), 10)       # layer0/w: D = 12544
    want = jax_run_federated(JaxFLConfig(client=JaxClientConfig(**CLIENT),
                                         **kw), model=jax_model)
    draws = JaxReplayDraws(kw["seed"], jax_model, kw["rounds"], kw["m"])
    got = run_federated(FLConfig(client=ClientConfig(**CLIENT), **kw),
                        model=make_mlp(784, (16,), 10), device="cpu",
                        draws=draws)
    return got, want


def _assert_runs_agree(got, want):
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
                               [a for _, a in want.test_acc], atol=1e-4)
    np.testing.assert_allclose([v for _, v in got.val_loss],
                               [v for _, v in want.val_loss], atol=1e-4)
    np.testing.assert_allclose(got.sv_final, np.asarray(want.sv_final),
                               atol=1e-4)
    for a, b in zip(tree_leaves(got.params), jax.tree.leaves(want.params)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)


@pytest.mark.parametrize("codec", ["identity", "quant8_topk"])
def test_greedyfed_loop_run_matches_reference(codec):
    """N=6, M=3, T=4: two round-robin rounds, then two greedy rounds."""
    got, want = _run_both(upload_codec=codec)
    _assert_runs_agree(got, want)
    # the greedy rounds pick the top-M cumulative SVs
    assert len({tuple(s) for s in got.selections[:2]}) == 2
    assert got.compile_time_s == 0.0
    assert len(got.round_time_s) == len(got.shapley_time_s) == 4


def test_power_of_choice_run_matches_reference():
    got, want = _run_both(selector="power_of_choice", rounds=3,
                          straggler_frac=0.5, privacy_sigma=0.05)
    _assert_runs_agree(got, want)


def test_centralized_run_matches_reference():
    kw = dict(SLICE, rounds=2)
    jax_model = jax_make_mlp(784, (16,), 10)
    want = jax_run_centralized(JaxFLConfig(client=JaxClientConfig(**CLIENT),
                                           **kw), model=jax_model)
    key = jax.random.key(kw["seed"])
    key, init_key = jax.random.split(key)
    round_keys = []
    for _ in range(kw["rounds"]):
        key, k = jax.random.split(key)
        round_keys.append(k)

    class CentralDraws:
        def init_params(self, model):
            return params_from_numpy(jax.tree.map(
                np.asarray, jax_model.init(init_key)))

        def round(self, t, plan):
            tables, noise = _slot_draws(round_keys[t], plan)
            return RoundDraws(SelectionDraw(), tables[None],
                              [leaf[None] for leaf in noise], None)

    got = run_centralized(FLConfig(client=ClientConfig(**CLIENT), **kw),
                          model=make_mlp(784, (16,), 10), device="cpu",
                          draws=CentralDraws())
    np.testing.assert_allclose([a for _, a in got.test_acc],
                               [a for _, a in want.test_acc], atol=1e-4)
    for a, b in zip(tree_leaves(got.params), jax.tree.leaves(want.params)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)


def test_default_draws_reproduce_and_cpu_never_counts_launches():
    cfg = FLConfig(client=ClientConfig(**CLIENT), **dict(SLICE, rounds=3))
    model = make_mlp(784, (16,), 10)
    kernels.reset_launches()
    a = run_federated(cfg, model=model, device="cpu")
    b = run_federated(cfg, model=model, device="cpu")
    assert kernels.LAUNCHES == {"prefix_avg": 0, "ce_loss": 0,
                                "cohort_gather": 0, "cohort_gather_shard": 0,
                                "delta_codec": 0, "weighted_avg": 0,
                                "flash_attention": 0,
                                "flash_attention_bwd": 0,
                                "flash_attention_wide": 0,
                                "flash_attention_wide_bwd": 0}
    for x, y in zip(a.selections, b.selections):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(a.sv_final, b.sv_final)
    assert a.final_acc == b.final_acc and np.isfinite(a.final_acc)


def test_entry_points_default_to_the_card():
    cfg = FLConfig(client=ClientConfig(**CLIENT), **SLICE)
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        run_federated(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_centralized(cfg)


@pytest.mark.parametrize("over", [
    {"engine": "batched", "faults": object()},
    {"engine": "batched", "faults": FaultSpec(kinds=("gremlin",))},
    {"faults": FaultSpec(rate=1.5)}, {"engine": "batched",
                                      "clients_shards": 2},
    {"clients_shards": 2},
])
def test_later_slices_raise_not_implemented(over):
    """A malformed fault spec is a ValueError before anything runs (faults
    run since the faults slice); client sharding runs since its slice,
    under engine="scan" only, as in the reference."""
    cfg = dataclasses.replace(FLConfig(**SLICE), **over)
    error, match = ((ValueError, "FaultSpec|kinds|rate") if "faults" in over
                    else (ValueError, "clients_shards > 1 requires"))
    with pytest.raises(error, match=match):
        run_federated(cfg, device="cpu")


def test_unknown_options_and_other_entry_points_raise():
    with pytest.raises(ValueError):
        run_federated(FLConfig(engine="warp"), device="cpu")
    with pytest.raises(ValueError):
        run_federated(FLConfig(shapley_impl="magic"), device="cpu")
    # the replicated engines run since the grid slice; grid options need
    # the scan engine
    with pytest.raises(ValueError, match="engine='scan'"):
        run_federated_replicated(FLConfig(**SLICE), seeds=(0, 1),
                                 device="cpu", rounds_per_segment=2)
