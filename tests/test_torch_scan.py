"""engine="scan" in the port on the CPU, against the port's batched engine
and the reference's own scan engine.

On the CPU the scan runs its captured round eagerly, round after round, on
the same static buffers the card's graphs use.  Tolerances: against the
port's batched engine everything is bitwise (the same draws and the same
ops: selections, SVs, params, eval history, byte counts, virtual-clock
time); against the reference's scan (the port fed the reference's draws
through `JaxReplayDraws`) selections and byte counts are equal and floats
agree at 1e-4, the bound `test_torch_engine.py` holds the batched engines
to (4 rounds of local SGD, averaging and Shapley walks in other orders).
A K-round segmented run equals the whole run bitwise.  The selector
switch is bitwise against `selection_jax` on a two-strategy tuple.  The
scan body runs with every way of reading a tensor back to the host
patched to raise.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import selection_jax as jsel
from repro.engine.scan_engine import build_epochs_table as jax_epochs_table
from repro.federated.client import ClientConfig as JaxClientConfig
from repro.federated.server import FLConfig as JaxFLConfig
from repro.federated.server import run_federated as jax_run_federated
from repro.federated.server import setup_run as jax_setup_run
from repro.kernels.cohort_gather.ref import cohort_gather_ref as jax_gather
from repro.models.mlp_cnn import make_mlp as jax_make_mlp
from repro_torch import kernels
from repro_torch.core import selection as sel
from repro_torch.core.shapley_batched import (
    gtg_shapley_batched, gtg_shapley_streaming,
)
from repro_torch.engine import (
    ScanSpec, SegmentCarry, build_epochs_table, make_run_scan,
    make_scan_spec, make_segment_step, scan_operands,
)
from repro_torch.engine.round_engine import round_plan
from repro_torch.engine.schedule import ScheduleConfig
from repro_torch.faults import FaultSpec
from repro_torch.federated.client import ClientConfig
from repro_torch.federated.draws import (
    minibatch_rows, stack_rounds,
)
from repro_torch.federated.server import FLConfig, run_federated, setup_run
from repro_torch.kernels.cohort_gather import cohort_gather, cohort_take
from repro_torch.kernels.cohort_gather.kernel import (
    error_word, raise_on_error,
)
from repro_torch.models.mlp_cnn import make_mlp
from repro_torch.tree import tree_leaves
from test_torch_engine import _mlp_case
from test_torch_server import JaxReplayDraws

SLICE = dict(n_clients=6, m=3, rounds=4, n_train=600, n_val=100, n_test=100,
             eval_every=2, shapley_max_iters=6, seed=0)
CLIENT = dict(epochs=2, batches_per_epoch=2, batch_size=16)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs six test files at once; at these small sizes torch's
    intra-op threads only contend for the cores (a grid test took 28 s
    with 8 threads beside a busy machine, 1 s with one)."""
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
    assert got.test_acc == want.test_acc and got.val_loss == want.val_loss
    assert got.sim_time_s == want.sim_time_s
    np.testing.assert_array_equal(got.sv_final, want.sv_final)
    np.testing.assert_array_equal(got.selection_counts,
                                  want.selection_counts)
    for a, b in zip(tree_leaves(got.params), tree_leaves(want.params)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("over", [
    {"selector": "random"}, {"selector": "power_of_choice"},
    {"selector": "s_fedavg"}, {"selector": "ucb"}, {"selector": "greedyfed"},
    {"selector": "greedyfed_dropout", "rounds": 5},
    {"upload_codec": "quant8_topk"},
    {"selector": "power_of_choice", "upload_codec": "quant8_topk"},
    {"straggler_frac": 0.5, "privacy_sigma": 0.05, "noise_level": 0.01},
    {"schedule": ScheduleConfig(deadline_s=0.6)},
    {"shapley_impl": "batched", "selector": "ucb"},
])
def test_scan_equals_batched_engine_bitwise(over):
    """One seed, one run: the scan makes the batched engine's run bit for
    bit on the CPU, and launches no kernel there."""
    cfg = _cfg(**over)
    model = make_mlp(784, (16,), 10)
    kernels.reset_launches()
    scan = run_federated(dataclasses.replace(cfg, engine="scan"),
                         model=model, device="cpu")
    assert all(v == 0 for v in kernels.LAUNCHES.values())
    batched = run_federated(dataclasses.replace(cfg, engine="batched"),
                            model=model, device="cpu")
    _assert_bitwise(scan, batched)
    # one replay a round and one an eval; nothing captured on the CPU
    assert scan.dispatches == cfg.rounds + len(scan.test_acc)
    assert scan.graph_launches is None and scan.shapley_time_s == ()
    assert len(scan.round_time_s) == cfg.rounds and scan.stage_time_s > 0
    if "schedule" in over:
        assert scan.sim_time_s > 0


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("over", [{}, {"selector": "greedyfed_dropout",
                                       "upload_codec": "topk"}])
def test_segments_chained_equal_the_whole_run(k, over):
    """K-round segments, the carry read back between them, make the whole
    run bit for bit (a last segment of T % K rounds included)."""
    cfg = _cfg(engine="scan", rounds=5, **over)
    model = make_mlp(784, (16,), 10)
    whole = run_federated(cfg, model=model, device="cpu")
    seg = run_federated(cfg, model=model, device="cpu",
                        rounds_per_segment=k)
    _assert_bitwise(seg, whole)
    assert seg.dispatches == whole.dispatches


def test_make_run_scan_is_one_segment_of_make_segment_step():
    """The library form: make_run_scan over the run's draws, and two
    segments of make_segment_step from its carry, agree bitwise."""
    cfg = _cfg(engine="scan", upload_codec="quant8")
    s = setup_run(cfg, model=make_mlp(784, (16,), 10), device="cpu")
    ops = scan_operands(cfg, s)
    spec = make_scan_spec(cfg, (s.sel_spec,))
    plan = round_plan(spec.round, cfg.client, (s.sel_spec,),
                      cfg.n_clients, cfg.m, s.params, s.n_valid.numpy())
    draws = [s.draws.round(t, plan) for t in range(cfg.rounds)]
    whole = make_run_scan(s.model, cfg.client, spec, ops)(
        s.params, s.sel_state, stack_rounds(draws))
    step = make_segment_step(s.model, cfg.client,
                             spec._replace(rounds_per_segment=2), ops)
    carry = SegmentCarry(s.params, s.sel_state, torch.zeros((),
                                                            dtype=torch.int64))
    outs = []
    for t0 in (0, 2):
        (out,) = step([carry], t0, [stack_rounds(draws[t0:t0 + 2])])
        outs.append(out)
        carry = out.carry
    assert torch.equal(torch.cat([o.selections for o in outs]),
                       whole.selections)
    assert torch.equal(torch.cat([o.sv for o in outs]), whole.sv)
    np.testing.assert_array_equal(
        torch.cat([o.test_acc for o in outs]).numpy(),
        whole.test_acc.numpy())
    assert int(whole.eval_count) == int(carry.eval_slot) == 2
    assert torch.isnan(whole.test_acc[0]) and not torch.isnan(
        whole.test_acc[1])
    for a, b in zip(tree_leaves(carry.params), tree_leaves(whole.params)):
        assert torch.equal(a, b)
    assert torch.equal(whole.granted, torch.full((4,), 3))
    with pytest.raises(ValueError, match="segment"):
        step([carry], 2, [stack_rounds(draws[:3])])


@pytest.mark.parametrize("over", [
    {}, {"upload_codec": "quant8_topk"},
    {"selector": "power_of_choice", "straggler_frac": 0.5,
     "privacy_sigma": 0.05}])
def test_scan_matches_reference_scan(over):
    """The port's scan on the reference's draws against the reference's
    own engine="scan": equal selections and bytes, floats at 1e-4."""
    kw = {**SLICE, **over, "engine": "scan"}
    jax_model = jax_make_mlp(784, (16,), 10)       # layer0/w: D = 12544
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


@pytest.mark.parametrize("variant", ["none", "stragglers", "schedule"])
def test_epochs_table_matches_reference(variant):
    kw = dict(SLICE, n_clients=9, rounds=5, seed=5)
    jkw = dict(kw)
    if variant == "stragglers":
        kw["straggler_frac"] = jkw["straggler_frac"] = 0.4
    if variant == "schedule":
        from repro.engine.schedule import ScheduleConfig as JaxSchedule
        kw["schedule"], jkw["schedule"] = ScheduleConfig(), JaxSchedule()
    cfg = FLConfig(client=ClientConfig(epochs=3), **kw)
    jcfg = JaxFLConfig(client=JaxClientConfig(epochs=3), **jkw)
    got = build_epochs_table(cfg, setup_run(cfg, device="cpu"))
    want = jax_epochs_table(jcfg, jax_setup_run(jcfg))
    np.testing.assert_array_equal(got, np.asarray(want))


_PAIRS = [("greedyfed", "random"), ("ucb", "power_of_choice"),
          ("s_fedavg", "greedyfed_dropout")]


@pytest.mark.parametrize("names", _PAIRS)
@pytest.mark.parametrize("strategy", [0, 1])
def test_selector_switch_matches_reference(names, strategy):
    """device_select_any / device_update_any over a two-strategy tuple,
    picked by a device id, against selection_jax's lax.switch."""
    n, m, t_max = 10, 3, 7
    jspecs = tuple(jsel.make_selector_spec(x, n, m) for x in names)
    tspecs = tuple(sel.make_selector_spec(x, n, m) for x in names)
    jstate = jsel.init_device_state(jspecs[0], seed=4)
    tstate = sel.init_device_state(tspecs[0], seed=4)
    rng = np.random.default_rng(9)
    fractions = rng.dirichlet(np.ones(n)).astype(np.float32)
    d_sched = jsel.poc_d_schedule(jspecs[1], t_max)
    sid = torch.tensor(strategy)
    for t, key in enumerate(jax.random.split(jax.random.key(2), t_max)):
        losses = rng.random(n).astype(np.float32)
        jctx = jsel.DeviceSelectionContext(
            jnp.asarray(fractions), jnp.asarray(losses),
            jnp.asarray(d_sched[t]))
        tctx = sel.DeviceSelectionContext(
            torch.from_numpy(fractions), torch.from_numpy(losses),
            torch.tensor(int(d_sched[t])))
        draw = sel.SelectionDraw(
            choice=torch.tensor(np.asarray(jax.random.choice(
                key, n, (m,), replace=False))),
            gumbel=torch.tensor(np.asarray(jax.random.gumbel(
                key, (n,), jnp.float32))))
        jchosen, jstate = jsel.device_select_any(jspecs, jnp.asarray(
            strategy), jstate, key, jctx)
        tchosen, tstate = sel.device_select_any(tspecs, sid, tstate, tctx,
                                                draw)
        np.testing.assert_array_equal(tchosen.numpy(), np.asarray(jchosen),
                                      err_msg=f"round {t}")
        sv = np.round(rng.standard_normal(m), 1).astype(np.float32)
        jstate = jsel.device_update_any(jspecs, jnp.asarray(strategy),
                                        jstate, jchosen, jnp.asarray(sv))
        tstate = sel.device_update_any(tspecs, sid, tstate, tchosen,
                                       torch.from_numpy(sv))
        assert int(tstate.round) == int(jstate.round) == t + 1
    np.testing.assert_allclose(tstate.valuation.sv.numpy(),
                               np.asarray(jstate.valuation.sv), atol=1e-7)
    np.testing.assert_array_equal(tstate.valuation.counts.numpy(),
                                  np.asarray(jstate.valuation.counts))
    np.testing.assert_array_equal(tstate.active.numpy(),
                                  np.asarray(jstate.active))
    assert bool(tstate.frozen) == bool(jstate.frozen)
    assert float(sel.device_dropped_fraction(tstate)) == float(
        jsel.device_dropped_fraction(jstate))


def test_one_spec_switch_and_cached_selector_pair():
    spec = sel.make_selector_spec("greedyfed", 6, 2)
    state = sel.init_device_state(spec, seed=1)
    ctx = sel.DeviceSelectionContext(torch.full((6,), 1 / 6),
                                     torch.zeros(6), 6)
    select, update = sel.jitted_selector(spec)
    assert sel.jitted_selector(spec)[0] is select
    a, sa = sel.device_select_any((spec,), torch.tensor(3), state, ctx,
                                  sel.SelectionDraw())
    b, sb = select(state, ctx, sel.SelectionDraw())
    assert torch.equal(a, b) and a.dtype == torch.int64
    assert int(update(sb, b).round) == 1
    assert float(sel.device_dropped_fraction(state)) == 0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.int64])
def test_cohort_gather_device_ids_plain_path(dtype):
    """Tensor ids take the plain path on the CPU, bitwise the reference's
    gather; an id outside [0, N) raises IndexError there, and an error word
    holding a bad id raises when it is read."""
    rng = np.random.default_rng(5)
    table = rng.standard_normal((7, 40)).astype(np.float32)
    table[2, ::3] = -0.0
    tree = {"a": torch.from_numpy(table).to(dtype),
            "b": torch.arange(14).reshape(7, 2)}
    ids = torch.tensor([6, 0, 2, 2])
    got = cohort_gather(tree, ids)
    want = jax_gather(jnp.asarray(tree["a"].numpy()), jnp.asarray(ids))
    np.testing.assert_array_equal(got["a"].numpy(), np.asarray(want))
    assert torch.equal(got["b"], tree["b"][ids])
    for bad in ([0, 7], [-1]):
        with pytest.raises(IndexError):
            cohort_take(tree["a"], torch.tensor(bad))
    word = error_word("cpu")
    assert word.dtype == torch.int64 and word.shape == (1,)
    raise_on_error(word, 7)             # zero: nothing to raise
    word.fill_(7)
    with pytest.raises(IndexError, match=r"\[0, 7\), got 7"):
        raise_on_error(word, 7)


@pytest.mark.parametrize("n", [1, 7, 1000, 2 ** 20, 2 ** 31 - 1])
def test_minibatch_rows_stay_below_n_valid(n):
    """31-bit draws scale to [0, n) exactly, even at the largest draws,
    where float32 u * n would round up to n."""
    bits = torch.tensor([[[0, 1, 2 ** 30, 2 ** 31 - 2, 2 ** 31 - 1]]])
    rows = minibatch_rows(bits, torch.tensor([0]), torch.tensor([n]))
    assert rows.dtype == torch.int64
    assert int(rows.min()) == 0 and int(rows.max()) == max(n - 1, 0)
    u = torch.tensor(2 ** 31 - 1, dtype=torch.float64) / 2 ** 31
    if n > 2 ** 24:   # the float32 product rounds to n or past it
        assert int(torch.floor(u.float() * n)) >= n
    tables = torch.arange(2 * 3 * 4).reshape(1, 2, 3, 4).expand(2, 2, 3, 4)
    picked = minibatch_rows(tables, torch.tensor([1, 0]), torch.tensor([5]))
    assert torch.equal(picked[0], tables[0, 1])
    assert torch.equal(picked[1], tables[1, 0])


@pytest.mark.parametrize("impl", ["streaming", "dense"])
@pytest.mark.parametrize("eps", [1e-4, 1e9])
def test_device_truncation_equals_the_host_skip(impl, eps):
    """skip_truncated=False computes the walk and selects on the device:
    the same SVs (zeros on a truncated round) and stats, as () tensors."""
    _, port_args = _mlp_case(3)
    perms = torch.stack([torch.randperm(3, generator=torch.Generator()
                                        .manual_seed(i)) for i in range(6)])
    fn = gtg_shapley_streaming if impl == "streaming" else \
        gtg_shapley_batched
    host_sv, host = fn(*port_args, perms, eps=eps)
    dev_sv, dev = fn(*port_args, perms, eps=eps, skip_truncated=False)
    assert torch.equal(dev_sv, host_sv)
    assert isinstance(dev.truncated_round, torch.Tensor)
    assert bool(dev.truncated_round) == host.truncated_round == (eps > 1)
    assert int(dev.utility_evals) == host.utility_evals
    assert int(dev.iterations) == host.iterations
    assert float(dev.v0) == host.v0 and float(dev.vM) == host.vM


def _raise(*args, **kwargs):
    raise AssertionError("the scan body read a tensor back to the host")


@pytest.mark.parametrize("over", [
    {"upload_codec": "quant8_topk"}, {"selector": "power_of_choice"},
    {"selector": "greedyfed_dropout", "rounds": 5, "shapley_impl": "batched"},
    {"upload_codec": "quant8_topk", "shapley_impl": "serial"},
    {"selector": "ucb", "straggler_frac": 0.5},
    {"upload_codec": "quant8_topk", "quarantine": True,
     "faults": FaultSpec(rate=0.4, kinds=("nan", "sign_flip", "crash"))},
    {"upload_codec": "quant8_topk", "telemetry": "live_tap"},
    {"upload_codec": "quant8_topk", "telemetry": "trace_dir"}])
def test_scan_body_reads_nothing_back(over, monkeypatch, tmp_path):
    """The replays (round bodies and evals) run with Tensor.item, .tolist,
    .cpu, .numpy, float(), int() and bool() of a tensor all raising, and
    still make the batched engine's run.  With the live tap the tap's host
    thread polls the rings meanwhile; with a capture window the replays
    run under the profiler with the stages' ranges (and, on a card, one
    graph a stage)."""
    from repro_torch.telemetry import Telemetry
    from repro_torch.telemetry.profile import trace_capture
    from repro_torch.telemetry.trace import live_sink

    over = dict(over)
    mode = over.pop("telemetry", None)
    cfg = _cfg(engine="scan", **over)
    model = make_mlp(784, (16,), 10)
    s = setup_run(cfg, model=model, device="cpu")
    ops = scan_operands(cfg, s)
    spec = make_scan_spec(cfg, (s.sel_spec,), live_tap=mode == "live_tap")
    plan = round_plan(spec.round, cfg.client, (s.sel_spec,),
                      cfg.n_clients, cfg.m, s.params, s.n_valid.numpy())
    step = make_segment_step(model, cfg.client, spec, ops,
                             stage_events=mode == "trace_dir")
    step.stage([SegmentCarry(s.params, s.sel_state,
                             torch.zeros((), dtype=torch.int64))], 0,
               [stack_rounds([s.draws.round(t, plan)
                              for t in range(cfg.rounds)])])
    tel = Telemetry(trace_dir=str(tmp_path)) if mode else None
    with monkeypatch.context() as mp, \
            live_sink(tel if mode == "live_tap" else None) as poller, \
            trace_capture(tel if mode == "trace_dir" else None):
        for name in ("item", "tolist", "cpu", "numpy", "__float__",
                     "__int__", "__bool__"):
            mp.setattr(torch.Tensor, name, _raise)
        with pytest.raises(AssertionError, match="read a tensor back"):
            bool(torch.ones(()))
        if poller is not None:
            poller.arm(step.tap_rings, 0, cfg.rounds)
        step.replay(0, cfg.rounds)
        if poller is not None:
            poller.finish()
    if mode == "live_tap":
        taps = [e for e in tel.events if e["event"] == "round_tap"]
        assert [e["round"] for e in taps] == list(range(cfg.rounds))
    if mode == "trace_dir":
        (prof,) = [e for e in tel.events if e["event"] == "profile"]
        assert prof["source"] == "trace"
        assert {"select", "train", "codec", "shapley", "aggregate",
                "eval"} <= set(prof["stage_wall_s"])
    (out,) = step.output(cfg.rounds)
    want = run_federated(dataclasses.replace(cfg, engine="batched"),
                         model=model, device="cpu")
    for t in range(cfg.rounds):
        np.testing.assert_array_equal(out.selections[t].numpy(),
                                      want.selections[t])
    for a, b in zip(tree_leaves(out.carry.params), tree_leaves(want.params)):
        assert torch.equal(a, b)


def test_scan_spec_and_later_slices():
    spec = make_scan_spec(_cfg(upload_codec="topk"),
                          (sel.make_selector_spec("random", 6, 3),
                           sel.make_selector_spec("ucb", 6, 3)))
    assert isinstance(spec, ScanSpec) and spec.round.needs_sv
    assert spec.round.shapley_max_iters == 6 and spec.rounds_per_segment == 0
    cfg = _cfg(engine="scan")
    s = setup_run(cfg, model=make_mlp(784, (16,), 10), device="cpu")
    # the live tap runs since the telemetry slice: each run gets a ring
    step = make_segment_step(s.model, cfg.client,
                             make_scan_spec(cfg, (s.sel_spec,),
                                            live_tap=True),
                             scan_operands(cfg, s))
    assert len(step.tap_rings) == 1
    # client sharding runs since its slice; a world of one rank has too few
    with pytest.raises(ValueError, match="needs that many ranks"):
        run_federated(_cfg(engine="scan", clients_shards=2), device="cpu")
    # faults and the screen run under the scan since the faults slice
    with pytest.raises(ValueError, match="kinds"):
        run_federated(_cfg(engine="scan", faults=FaultSpec(kinds=())),
                      device="cpu")
    res = run_federated(_cfg(engine="scan", quarantine=True), device="cpu")
    assert len(res.selections) == SLICE["rounds"]
    bad = s._replace(y_val=s.y_val.clone().fill_(10))
    with pytest.raises(ValueError, match="labels"):
        scan_operands(cfg, bad)


def test_scan_checks_its_draws_where_they_are_staged():
    """Drawn cohorts and walks are range-checked on the host when a
    segment is staged, before any round runs."""
    from repro_torch.federated.draws import TorchDraws

    class Bad(TorchDraws):
        def __init__(self, seed, device, field):
            super().__init__(seed, device)
            self.field = field

        def round(self, t, plan):
            rd = super().round(t, plan)
            if self.field == "choice":
                rd.selection.choice[0] = plan.n_clients
            else:
                rd.walks[0, 0] = -1
            return rd

    for field, over in (("choice", {"selector": "random"}), ("walks", {})):
        cfg = _cfg(engine="scan", **over)
        with pytest.raises(ValueError, match="must index"):
            run_federated(cfg, device="cpu", draws=Bad(cfg.seed, "cpu",
                                                       field))
