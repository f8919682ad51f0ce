"""The port's numpy host layer against the reference's: datasets,
partitions, schedule tables and the run set-up, compared bitwise."""
import dataclasses

import numpy as np
import pytest

from repro.data.synth import make_dataset as jax_make_dataset
from repro.engine import schedule as jax_schedule
from repro.federated import partition as jax_partition
from repro.federated.client import ClientConfig as JaxClientConfig
from repro.federated.server import FLConfig as JaxFLConfig
from repro.federated.server import setup_run as jax_setup_run
from repro_torch.data.synth import make_dataset
from repro_torch.engine import schedule
from repro_torch.federated import partition
from repro_torch.federated.client import ClientConfig
from repro_torch.federated.server import FLConfig, setup_run


@pytest.mark.parametrize("name,seed", [("mnist", 0), ("fmnist", 3),
                                       ("cifar10", 1)])
def test_synth_datasets_equal(name, seed):
    kw = dict(n_train=120, n_val=30, n_test=40, difficulty=1.3, seed=seed)
    got, want = make_dataset(name, **kw), jax_make_dataset(name, **kw)
    assert got.name == want.name and got.input_shape == want.input_shape
    for field in ("x_train", "y_train", "x_val", "y_val", "x_test", "y_test"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        make_dataset("imagenet")


@pytest.mark.parametrize("alpha", [1e-4, 0.1, 100.0])
def test_partitions_and_padded_blocks_equal(alpha):
    data = make_dataset("mnist", n_train=500, n_val=10, n_test=10, seed=2)
    got_rng, want_rng = np.random.default_rng(9), np.random.default_rng(9)
    fr = partition.power_law_fractions(12, got_rng)
    np.testing.assert_array_equal(
        fr, jax_partition.power_law_fractions(12, want_rng))
    got = partition.dirichlet_partition(data.y_train, 12, alpha, got_rng, fr)
    want = jax_partition.dirichlet_partition(data.y_train, 12, alpha,
                                             want_rng, fr)
    assert len(got) == len(want) == 12
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    # the rng streams stay in step after the partition
    assert got_rng.integers(1 << 30) == want_rng.integers(1 << 30)
    cap = partition.client_cap(got)
    assert cap == jax_partition.client_cap(want)
    for lo, hi in ((0, 12), (3, 9), (10, 14)):
        np.testing.assert_array_equal(
            partition.padded_x_block(data.x_train, got, cap, lo, hi),
            jax_partition.padded_x_block(data.x_train, want, cap, lo, hi))
        np.testing.assert_array_equal(
            partition.padded_y_block(data.y_train, got, cap, lo, hi),
            jax_partition.padded_y_block(data.y_train, want, cap, lo, hi))
        np.testing.assert_array_equal(partition.valid_counts(got, lo, hi),
                                      jax_partition.valid_counts(want, lo, hi))
    assert partition.partition_summary(got, data.y_train) == \
        jax_partition.partition_summary(want, data.y_train)


def test_schedule_tables_equal():
    for rounds, every in ((7, 3), (5, 9), (6, 1), (0, 2)):
        np.testing.assert_array_equal(schedule.eval_mask(rounds, every),
                                      jax_schedule.eval_mask(rounds, every))
    with pytest.raises(ValueError):
        schedule.eval_mask(3, 0)
    a, b = np.random.default_rng(4), np.random.default_rng(4)
    np.testing.assert_array_equal(
        schedule.straggler_epochs_table(a, 6, 10, {1, 4, 7}, 5),
        jax_schedule.straggler_epochs_table(b, 6, 10, {1, 4, 7}, 5))
    scfg = schedule.ScheduleConfig(deadline_s=0.8)
    jcfg = jax_schedule.ScheduleConfig(deadline_s=0.8)
    n_k = np.arange(10, 20)
    clk = schedule.make_client_clock(scfg, 10, 712440, a, n_k=n_k)
    jclk = jax_schedule.make_client_clock(jcfg, 10, 712440, b, n_k=n_k)
    np.testing.assert_array_equal(clk.epoch_time_s, jclk.epoch_time_s)
    np.testing.assert_array_equal(clk.comm_time_s, jclk.comm_time_s)
    np.testing.assert_array_equal(
        schedule.deadline_epochs_table(clk, scfg, 4, 5),
        jax_schedule.deadline_epochs_table(jclk, jcfg, 4, 5))
    sel = np.array([3, 0, 7])
    e = schedule.deadline_epochs(clk, scfg, sel, 5)
    np.testing.assert_array_equal(e, jax_schedule.deadline_epochs(jclk, jcfg,
                                                                  sel, 5))
    assert schedule.round_duration_s(clk, scfg, sel, e) == \
        jax_schedule.round_duration_s(jclk, jcfg, sel, e)
    vc = schedule.VirtualClock()
    vc.advance(0.25)
    assert vc.advance(0.5) == 0.75


SETUP = dict(n_clients=9, m=3, rounds=5, n_train=400, n_val=40, n_test=40,
             dirichlet_alpha=0.1, straggler_frac=0.4, privacy_sigma=0.05,
             noise_level=0.02, seed=5)


@pytest.mark.parametrize("variant", ["stragglers", "schedule"])
def test_setup_run_draws_equal(variant):
    """setup_run consumes the numpy rng in the reference's order: same
    partition, stragglers, noise levels and budget tables."""
    kw = dict(SETUP)
    jkw = dict(SETUP)
    if variant == "schedule":
        kw["schedule"] = schedule.ScheduleConfig()
        jkw["schedule"] = jax_schedule.ScheduleConfig()
    got = setup_run(FLConfig(client=ClientConfig(epochs=3), **kw),
                    device="cpu")
    want = jax_setup_run(JaxFLConfig(client=JaxClientConfig(epochs=3), **jkw))
    np.testing.assert_array_equal(got.fractions, want.fractions)
    np.testing.assert_array_equal(got.xs.numpy(), np.asarray(want.xs))
    np.testing.assert_array_equal(got.ys.numpy(), np.asarray(want.ys))
    np.testing.assert_array_equal(got.n_valid.numpy(), np.asarray(want.n_valid))
    np.testing.assert_array_equal(got.n_k_all.numpy(), np.asarray(want.n_k_all))
    assert got.straggler_ids == want.straggler_ids
    np.testing.assert_array_equal(got.sigma_k_all, want.sigma_k_all)
    assert got.model_bytes == want.model_bytes == 712440
    np.testing.assert_array_equal(got.sel_state.rr_order.numpy(),
                                  np.asarray(want.sel_state.rr_order))
    if variant == "schedule":
        assert got.epochs_table is None and want.epochs_table is None
        np.testing.assert_array_equal(got.clock.epoch_time_s,
                                      want.clock.epoch_time_s)
    else:
        np.testing.assert_array_equal(got.epochs_table, want.epochs_table)
    # the rngs are in step after set-up (round_epochs' lazy draws follow)
    assert got.rng.integers(1 << 30) == want.rng.integers(1 << 30)


def test_round_epochs_matches_reference_at_rev0():
    from repro.federated.server import round_epochs as jax_round_epochs
    from repro_torch.federated.server import round_epochs
    kw = dict(SETUP, straggler_rev=0)
    cfg = FLConfig(**kw)
    got, want = setup_run(cfg, device="cpu"), jax_setup_run(JaxFLConfig(**kw))
    for t, sel in enumerate([np.arange(3), np.array([8, 2, 5]),
                             np.array([1, 4, 6])]):
        np.testing.assert_array_equal(
            round_epochs(cfg, got, sel, t),
            jax_round_epochs(JaxFLConfig(**kw), want, sel, t))


def test_flconfig_fields_and_defaults_equal():
    got = {f.name: f.default for f in dataclasses.fields(FLConfig)}
    want = {f.name: f.default for f in dataclasses.fields(JaxFLConfig)}
    assert got.keys() == want.keys()
    for name in got:
        if name == "selector_kwargs":
            continue
        if name == "client":
            assert tuple(got[name]) == tuple(want[name])
            assert got[name]._fields == want[name]._fields
        else:
            assert got[name] == want[name], name
