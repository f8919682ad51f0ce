"""repro_torch.faults against repro.faults, and the hardened round on the
port's three engines, on the CPU.

Tolerances: the fault tables, the `setup_run` stream, masks, codes,
selections, quarantined counts, byte counts and the rows the hardening
replaces or leaves untouched are held bitwise; delta norms and the
screen's cutoff at 1e-6 relative (f32 sums taken in other orders); the
rows a fault rescales at 1e-6; whole runs against the reference's
engine="scan" (the port fed the reference's draws through
`JaxReplayDraws`) at 1e-4 for params, SVs and evals, the bound
`tests/test_torch_scan.py` holds the clean runs to.  The port's loop,
batched and scan engines are held to each other bitwise.  Where a
quarantined client starts a walk, the reference's XLA flushes the
subnormal products 2^-100 * w (|w| < 2^-26) to zero and the port keeps
them; those entries are below 2^-26 and inside the 1e-4 bound.  Whole
runs take the reference's `TINY` fault config on the 784-16-10 MLP that
the other port run tests use, to keep the file short under the suite's
parallel workers.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.faults import FaultSpec as JaxFaultSpec
from repro.faults import apply_faults as jax_apply_faults
from repro.faults import draw_fault_table as jax_draw_fault_table
from repro.faults import harden_cohort as jax_harden_cohort
from repro.faults import masked_average as jax_masked_average
from repro.faults import screen_cohort as jax_screen_cohort
from repro.federated.client import ClientConfig as JaxClientConfig
from repro.federated.server import FLConfig as JaxFLConfig
from repro.federated.server import run_federated as jax_run_federated
from repro.federated.server import setup_run as jax_setup_run
from repro.models.mlp_cnn import make_mlp as jax_make_mlp
from repro_torch.faults import (
    CODE_CRASH, CODE_INF, CODE_NAN, CODE_NONE, CODE_SCALE, CODE_SIGN_FLIP,
    FAULT_KINDS, TINY_WEIGHT, FaultSpec, apply_faults, draw_fault_table,
    harden_cohort, masked_average, screen_cohort,
)
from repro_torch.faults.quarantine import nanmedian, screen_stats
from repro_torch.federated.client import ClientConfig
from repro_torch.federated.server import FLConfig, setup_run
from repro_torch.federated.server import run_federated as _run_federated
from repro_torch.models.mlp_cnn import make_mlp
from repro_torch.tree import tree_leaves
from test_torch_server import JaxReplayDraws

TINY = dict(n_clients=8, m=3, rounds=6, n_train=600, n_val=100, n_test=100,
            eval_every=3)
CLIENT = dict(epochs=2, batches_per_epoch=2, batch_size=16)
FAULTS = dict(rate=0.4, kinds=("nan", "sign_flip", "crash"), scale=10.0)
MODEL = make_mlp(784, (16,), 10)      # narrow, as the other port run tests


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs six test files at once; at these small sizes torch's
    intra-op threads only contend for the cores (a grid test took 28 s
    with 8 threads beside a busy machine, 1 s with one)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run_federated(cfg, **kw):
    return _run_federated(cfg, model=MODEL, **kw)


def _cfg(**over):
    kw = dict(selector="greedyfed", engine="scan", shapley_max_iters=10,
              **TINY) | over
    return FLConfig(client=ClientConfig(**CLIENT), **kw)


def _flat(params) -> np.ndarray:
    return np.concatenate([x.numpy().ravel() for x in tree_leaves(params)])


def _assert_bitwise(got, want):
    assert len(got.selections) == len(want.selections)
    for a, b in zip(got.selections, want.selections):
        np.testing.assert_array_equal(a, b)
    assert got.quarantined_total == want.quarantined_total
    assert got.upload_bytes == want.upload_bytes
    assert got.download_bytes == want.download_bytes
    assert got.shapley_evals == want.shapley_evals
    assert got.test_acc == want.test_acc and got.val_loss == want.val_loss
    np.testing.assert_array_equal(got.sv_final, want.sv_final)
    for a, b in zip(tree_leaves(got.params), tree_leaves(want.params)):
        assert torch.equal(a, b)


# ------------------------------------------------------------- the table --
@pytest.mark.parametrize("spec", [
    {}, {"rate": 0.5, "kinds": ("nan", "crash"), "start_round": 3},
    {"rate": 1.0, "kinds": ("inf",)}, {"rate": 0.0},
    {"rate": 0.3, "kinds": FAULT_KINDS, "scale": 3.0},
    {"rate": 0.7, "kinds": ("sign_flip",), "start_round": 20}])
def test_fault_table_bitwise_equals_reference(spec):
    """The same table and the same rng position after it, whatever
    fires."""
    rng_p, rng_j = np.random.default_rng(7), np.random.default_rng(7)
    got = draw_fault_table(FaultSpec(**spec), 10, 16, rng_p)
    want = jax_draw_fault_table(JaxFaultSpec(**spec), 10, 16, rng_j)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert rng_p.random() == rng_j.random()
    if spec.get("start_round", 0):
        assert (got[:spec["start_round"]] == CODE_NONE).all()


@pytest.mark.parametrize("bad", [
    {"kinds": ("gremlin",)}, {"kinds": ()}, {"rate": 1.5}, {"rate": -0.1},
    {"start_round": -1}])
def test_fault_spec_validation_matches_reference(bad):
    with pytest.raises(ValueError) as got:
        FaultSpec(**bad).validate()
    with pytest.raises(ValueError) as want:
        JaxFaultSpec(**bad).validate()
    assert str(got.value) == str(want.value)


def test_setup_run_table_and_stream_match_reference():
    """The table comes after every other draw of the run's rng and only
    with faults on: it equals the reference's, and a faulty config keeps
    its fault-free twin's stream (fractions, sigmas, straggler table)."""
    over = dict(straggler_frac=0.5, privacy_sigma=0.05, noise_level=0.01,
                faults=FaultSpec(**FAULTS))
    got = setup_run(_cfg(**over), device="cpu")
    want = jax_setup_run(JaxFLConfig(
        client=JaxClientConfig(**CLIENT), selector="greedyfed",
        engine="scan", shapley_max_iters=10, **TINY,
        **(over | {"faults": JaxFaultSpec(**FAULTS)})))
    np.testing.assert_array_equal(got.fault_table, want.fault_table)
    assert (got.fault_table != CODE_NONE).any()
    plain = setup_run(_cfg(**(over | {"faults": None})), device="cpu")
    assert plain.fault_table is None
    np.testing.assert_array_equal(plain.fractions, got.fractions)
    np.testing.assert_array_equal(plain.sigma_k_all, got.sigma_k_all)
    np.testing.assert_array_equal(plain.epochs_table, got.epochs_table)
    np.testing.assert_array_equal(got.epochs_table, want.epochs_table)
    np.testing.assert_array_equal(got.sigma_k_all, want.sigma_k_all)


# ---------------------------------------------------- the stage, unit level --
def _stacks(m, seed=0, spread=None):
    """A two-level tree of params and an (M, ...) cohort around it, numpy
    float32, with row i's delta scaled by spread[i]."""
    rng = np.random.default_rng(seed)
    p = {"a": {"w": rng.standard_normal((6, 5)).astype(np.float32),
               "b": rng.standard_normal((5,)).astype(np.float32)},
         "c": rng.standard_normal((7,)).astype(np.float32)}
    spread = np.ones(m) if spread is None else np.asarray(spread)
    w = jax.tree.map(lambda x: (x[None] + (0.1 * spread).reshape(
        (m,) + (1,) * x.ndim).astype(np.float32)
        * rng.standard_normal((m,) + x.shape).astype(np.float32)
    ).astype(np.float32), p)
    n_k = rng.integers(10, 200, m).astype(np.float32)
    return p, w, n_k


def _torch(tree):
    return jax.tree.map(torch.from_numpy, tree)


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


_CASES = {
    "mixed": ([CODE_NONE, CODE_NAN, CODE_SIGN_FLIP, CODE_CRASH, CODE_NONE],
              FAULTS, True),
    "inf and scale": ([CODE_INF, CODE_SCALE, CODE_NONE, CODE_NONE,
                       CODE_SIGN_FLIP], dict(FAULTS, kinds=FAULT_KINDS),
                      True),
    "even finite count": ([CODE_NAN, CODE_NONE, CODE_NONE, CODE_NONE,
                           CODE_NONE], FAULTS, True),
    "all nan": ([CODE_NAN] * 5, FAULTS, True),
    "all crash": ([CODE_CRASH] * 5, FAULTS, True),
    "no screen": ([CODE_SIGN_FLIP, CODE_NAN, CODE_CRASH, CODE_NONE,
                   CODE_SCALE], dict(FAULTS, kinds=FAULT_KINDS), False),
    "screen only": ([CODE_NONE] * 5, None, True),
}


@pytest.mark.parametrize("case", list(_CASES))
def test_harden_cohort_matches_reference(case):
    codes, faults, quarantine = _CASES[case]
    p, w, n_k = _stacks(5, spread=[1.0, 0.5, 2.0, 1.0, 30.0])
    codes = np.asarray(codes, np.int32)
    got = harden_cohort(_torch(w), _torch(p), torch.from_numpy(n_k),
                        torch.from_numpy(codes).long(),
                        faults=None if faults is None else FaultSpec(**faults),
                        quarantine=quarantine, z=8.0)
    want = jax_harden_cohort(
        _jax(w), _jax(p), jnp.asarray(n_k), jnp.asarray(codes),
        faults=None if faults is None else JaxFaultSpec(**faults),
        quarantine=quarantine, z=8.0)
    ok = np.asarray(want.ok)
    np.testing.assert_array_equal(got.ok.numpy(), ok)
    assert int(got.quarantined) == int(want.quarantined) == (~ok).sum()
    assert got.quarantined.dtype == torch.int32
    np.testing.assert_array_equal(got.n_k_agg.numpy(), np.asarray(
        want.n_k_agg))
    np.testing.assert_array_equal(got.n_k_sv.numpy(), np.asarray(want.n_k_sv))
    assert (got.n_k_sv.numpy()[~ok] == np.float32(TINY_WEIGHT)).all()
    exact = ~ok | np.isin(codes, [CODE_NONE, CODE_CRASH])
    for a, b, x in zip(tree_leaves(got.stacked), jax.tree.leaves(want.stacked),
                       jax.tree.leaves(p)):
        a, b = a.numpy(), np.asarray(b)
        np.testing.assert_array_equal(a[exact], b[exact])
        np.testing.assert_allclose(a[~exact], b[~exact], rtol=1e-6, atol=0)
        np.testing.assert_array_equal(a[~ok], np.broadcast_to(
            x, a[~ok].shape))
    if case in ("all nan", "all crash"):
        assert not ok.any()
    # the masked average: close to the reference's, and w_prev bitwise
    # when no row survives
    avg = masked_average(got.stacked, got.n_k_agg, got.ok, _torch(p))
    ref = jax_masked_average(want.stacked, want.n_k_agg, want.ok, _jax(p))
    for a, b, x in zip(tree_leaves(avg), jax.tree.leaves(ref),
                       jax.tree.leaves(p)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)
        if not ok.any():
            np.testing.assert_array_equal(a.numpy(), x)


def test_harden_cohort_static_passthrough():
    p, w, n_k = _stacks(3)
    w, p, n_k = _torch(w), _torch(p), torch.from_numpy(n_k)
    h = harden_cohort(w, p, n_k, None, faults=None, quarantine=False, z=8.0)
    assert h.stacked is w and h.n_k_agg is n_k and h.n_k_sv is n_k
    assert h.ok.all() and int(h.quarantined) == 0


def test_apply_faults_matches_reference():
    p, w, _ = _stacks(6, seed=3)
    codes = np.asarray([CODE_NONE, CODE_NAN, CODE_INF, CODE_SIGN_FLIP,
                        CODE_SCALE, CODE_CRASH], np.int32)
    got = apply_faults(_torch(w), _torch(p), torch.from_numpy(codes), 10.0)
    want = jax_apply_faults(_jax(w), _jax(p), jnp.asarray(codes), 10.0)
    for a, b, x in zip(tree_leaves(got), jax.tree.leaves(want),
                       jax.tree.leaves(w)):
        a, b = a.numpy(), np.asarray(b)
        for i in (0, 5):              # untouched rows: the input, bitwise
            np.testing.assert_array_equal(a[i], x[i])
            np.testing.assert_array_equal(a[i], b[i])
        assert np.isnan(a[1]).all() and np.isposinf(a[2]).all()
        np.testing.assert_array_equal(a[1:3], b[1:3])
        np.testing.assert_allclose(a[3:5], b[3:5], rtol=1e-6)


def _jax_screen_parts(w, p, z, rel_floor=0.1):
    """The reference's `screen_cohort` (quarantine.py:75-101), its norms
    and cutoff kept apart."""
    ws, ps = jax.tree.leaves(w), jax.tree.leaves(p)
    m = ws[0].shape[0]
    sq = jnp.zeros((m,), jnp.float32)
    finite = jnp.ones((m,), bool)
    for a, b in zip(ws, ps):
        d = (a - b[None]).reshape(m, -1).astype(jnp.float32)
        finite = finite & jnp.isfinite(d).all(axis=1)
        sq = sq + jnp.sum(d * d, axis=1)
    norm = jnp.sqrt(sq)
    masked = jnp.where(finite, norm, jnp.nan)
    med = jnp.nanmedian(masked)
    mad = jnp.nanmedian(jnp.abs(masked - med))
    return finite, norm, med + z * (1.4826 * mad + rel_floor * med + 1e-6)


@pytest.mark.parametrize("spread", [
    [1.0, 1.1, 0.9, 1.0, 1.05], [1.0, 1.0, 50.0, 1.0],
    [1.0, 2.0, 3.0, 40.0], [0.0, 0.0, 0.0], [1.0, 30.0]])
@pytest.mark.parametrize("poison", [(), (0,), (0, 1)])
def test_screen_norms_and_cutoff_match_reference(spread, poison):
    """Norms and cutoff at 1e-6 relative, the mask bitwise, with NaN rows
    making the count of finite norms odd or even (or zero)."""
    m = len(spread)
    p, w, _ = _stacks(m, seed=len(spread), spread=spread)
    for i in poison:
        if i < m:
            w["c"][i, 0] = np.nan
    finite, norm, cutoff = screen_stats(_torch(w), _torch(p), z=2.0)
    f_want, n_want, c_want = _jax_screen_parts(_jax(w), _jax(p), 2.0)
    np.testing.assert_array_equal(finite.numpy(), np.asarray(f_want))
    np.testing.assert_allclose(norm.numpy(), np.asarray(n_want), rtol=1e-6)
    np.testing.assert_allclose(cutoff.numpy(), np.asarray(c_want), rtol=1e-6)
    np.testing.assert_array_equal(
        screen_cohort(_torch(w), _torch(p), z=2.0).numpy(),
        np.asarray(jax_screen_cohort(_jax(w), _jax(p), z=2.0)))


@pytest.mark.parametrize("x", [
    [1.0, 2.0, np.nan, 4.0, 8.0], [3.0, 1.0, 2.0], [np.nan] * 4, [5.0],
    [np.inf, 1.0, np.nan, 2.0], [2.0, 2.0, np.nan, 7.0, np.nan, 1.0]])
def test_nanmedian_is_the_reference_midpoint(x):
    """`jnp.nanmedian` takes the midpoint of the two middle values;
    `torch.nanmedian` would take the lower one."""
    x = np.asarray(x, np.float32)
    got = nanmedian(torch.from_numpy(x))
    want = np.asarray(jnp.nanmedian(jnp.asarray(x)))
    assert got.shape == () and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


# --------------------------------------------------------- whole runs ------
def _against_reference_scan(**over):
    jax_over = dict(over)
    if "faults" in over:
        jax_over["faults"] = JaxFaultSpec(**over["faults"])
        over = over | {"faults": FaultSpec(**over["faults"])}
    kw = dict(selector="greedyfed", engine="scan", shapley_max_iters=10,
              seed=0, **TINY)
    jax_model = jax_make_mlp(784, (16,), 10)
    want = jax_run_federated(JaxFLConfig(client=JaxClientConfig(**CLIENT),
                                         **kw, **jax_over), model=jax_model)
    got = run_federated(FLConfig(client=ClientConfig(**CLIENT), **kw,
                                 **over), device="cpu",
                        draws=JaxReplayDraws(0, jax_model, kw["rounds"],
                                             kw["m"]))
    return got, want


@pytest.mark.parametrize("over", [
    {"faults": FAULTS, "quarantine": True},
    {"faults": dict(rate=0.4, kinds=("crash",)), "shapley_impl": "batched"}])
def test_hardened_run_matches_reference_scan(over):
    got, want = _against_reference_scan(**over)
    for a, b in zip(got.selections, want.selections):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert got.quarantined_total == want.quarantined_total > 0
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


@pytest.mark.parametrize("over", [
    {}, {"upload_codec": "quant8_topk"}, {"shapley_impl": "batched"},
    {"selector": "ucb", "straggler_frac": 0.5},
    {"faults": FaultSpec(rate=0.5, kinds=FAULT_KINDS, start_round=2)}])
def test_engines_bitwise_under_faults(over):
    """loop == batched == scan, bit for bit, under injected faults."""
    cfg = _cfg(**({"faults": FaultSpec(**FAULTS), "quarantine": True}
                  | over))
    scan = run_federated(cfg, device="cpu")
    assert scan.quarantined_total > 0
    for engine in ("loop", "batched"):
        _assert_bitwise(run_federated(dataclasses.replace(cfg, engine=engine),
                                      device="cpu"), scan)


@pytest.mark.parametrize("engine", ["loop", "batched", "scan"])
def test_quarantine_on_clean_run_is_bitwise_off(engine):
    plain = run_federated(_cfg(engine=engine), device="cpu")
    hard = run_federated(_cfg(engine=engine, quarantine=True), device="cpu")
    _assert_bitwise(hard, plain)
    assert hard.quarantined_total == 0


@pytest.mark.parametrize("engine", ["loop", "batched", "scan"])
def test_nan_storm_poisons_unscreened_and_is_quarantined_screened(engine):
    storm = FaultSpec(rate=1.0, kinds=("nan",))
    poisoned = run_federated(_cfg(engine=engine, faults=storm), device="cpu")
    assert not np.isfinite(_flat(poisoned.params)).all()
    clean = run_federated(_cfg(engine=engine, faults=storm, quarantine=True),
                          device="cpu")
    assert clean.quarantined_total == TINY["rounds"] * TINY["m"]
    assert clean.upload_bytes == 0
    np.testing.assert_array_equal(clean.sv_final,
                                  np.zeros(TINY["n_clients"], np.float32))
    init = setup_run(_cfg(), model=MODEL, device="cpu").params
    for a, b in zip(tree_leaves(clean.params), tree_leaves(init)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("engine", ["loop", "scan"])
def test_crash_faults_mask_without_screen(engine):
    res = run_federated(_cfg(engine=engine, faults=FaultSpec(
        rate=1.0, kinds=("crash",))), device="cpu")
    assert res.quarantined_total == TINY["rounds"] * TINY["m"]
    assert res.upload_bytes == 0
    init = setup_run(_cfg(), model=MODEL, device="cpu").params
    for a, b in zip(tree_leaves(res.params), tree_leaves(init)):
        assert torch.equal(a, b)


def test_bad_fault_specs_and_codes_raise():
    with pytest.raises(ValueError, match="FaultSpec"):
        run_federated(_cfg(faults=object()), device="cpu")
    with pytest.raises(ValueError, match="rate"):
        run_federated(_cfg(faults=FaultSpec(rate=2.0)), device="cpu")
    from repro_torch.engine import scan_operands
    cfg = _cfg(faults=FaultSpec(**FAULTS))
    s = setup_run(cfg, device="cpu")
    s.fault_table[0, 0] = CODE_CRASH + 1
    with pytest.raises(ValueError, match="fault codes"):
        scan_operands(cfg, s)
