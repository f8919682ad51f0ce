"""`repro_torch.telemetry` on the CPU, beside the reference's
`repro.telemetry`.

Held here: every telemetry mode (off, host sink, live tap, capture window)
leaves each engine's run bit for bit what it is (selections, params, SVs,
eval history, bytes, dispatches); the port's event stream equals the
reference's on the reference's draws event type for event type, with
counts, selections and bytes exact and SVs and accuracies at 1e-4 (the
bound `test_torch_scan.py` holds the two scans to); each package's
validator accepts the other's streams and the two agree on well-formed and
malformed ones; `report`, `merge` and `regress` give the same results in
both packages; a sink-observed segmented grid killed and resumed equals
the unobserved whole grid bit for bit; the capture window and the cost
card (matrix-product FLOPs of the round counted by hand for the
784-16-10 MLP).  Where the reference's tests use JAX-only facts (the jit
compile listener, XLA cost analysis) the port is held to its own stated
behaviour: compile seconds are the kernel build and the graph capture,
none on the CPU.
"""
import json
import os

import numpy as np
import pytest
import torch

from repro.faults import FaultSpec as JaxFaultSpec
from repro.federated.client import ClientConfig as JaxClientConfig
from repro.federated.server import FLConfig as JaxFLConfig
from repro.federated.server import run_federated as jax_run_federated
from repro.models.mlp_cnn import make_mlp as jax_make_mlp
from repro.telemetry import Telemetry as JaxTelemetry
from repro.telemetry import TelemetryError as JaxTelemetryError
from repro.telemetry import merge as jax_merge
from repro.telemetry import regress as jax_regress
from repro.telemetry import report as jax_report
from repro.telemetry import trace as jax_trace
from repro.telemetry import validate_events as jax_validate
from repro_torch import telemetry
from repro_torch.faults import FaultSpec
from repro_torch.federated.client import ClientConfig
from repro_torch.federated.server import (
    FLConfig, run_federated, run_federated_replicated,
)
from repro_torch.grid import GridSpec, run_grid
from repro_torch.grid import runner
from repro_torch.models.mlp_cnn import make_mlp
from repro_torch.telemetry import (
    SCHEMA_VERSION, Telemetry, TelemetryError, read_events, validate_events,
)
from repro_torch.telemetry import merge, profile, regress, report, trace
from repro_torch.tree import tree_leaves
from test_torch_server import JaxReplayDraws

SLICE = dict(n_clients=6, m=3, rounds=4, n_train=600, n_val=100, n_test=100,
             eval_every=2, shapley_max_iters=6, seed=0)
CLIENT = dict(epochs=2, batches_per_epoch=2, batch_size=16)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Whole runs at small sizes: one torch thread, so six test files at
    once do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(**over):
    return FLConfig(client=ClientConfig(**CLIENT), **{**SLICE, **over})


def _model():
    return make_mlp(784, (16,), 10)


def _assert_bitwise(got, want):
    assert len(got.selections) == len(want.selections)
    for a, b in zip(got.selections, want.selections):
        np.testing.assert_array_equal(a, b)
    assert got.upload_bytes == want.upload_bytes
    assert got.download_bytes == want.download_bytes
    assert got.shapley_evals == want.shapley_evals
    assert got.quarantined_total == want.quarantined_total
    assert got.test_acc == want.test_acc and got.val_loss == want.val_loss
    assert got.dispatches == want.dispatches
    np.testing.assert_array_equal(got.sv_final, want.sv_final)
    for a, b in zip(tree_leaves(got.params), tree_leaves(want.params)):
        assert torch.equal(a, b)


def _kinds(events):
    return [e["event"] for e in events]


# ---- bit-neutrality ------------------------------------------------------

@pytest.mark.parametrize("engine", ["loop", "batched", "scan"])
def test_telemetry_is_bit_neutral(engine, tmp_path):
    """Off, a host sink, the live tap (scan) and a capture window make the
    same run; the streams validate and count what the run did."""
    cfg = _cfg(engine=engine, upload_codec="quant8_topk")
    model = _model()
    off = run_federated(cfg, model=model, device="cpu")
    modes = {"host": {}, "trace": {"trace_dir": str(tmp_path)}}
    if engine == "scan":
        modes["live"] = {"live_tap": True}
    for mode, kw in modes.items():
        tel = Telemetry(**kw)
        on = run_federated(cfg, model=model, device="cpu", telemetry=tel)
        _assert_bitwise(on, off)
        assert validate_events(tel.events) == len(tel.events)
        kinds = _kinds(tel.events)
        assert kinds[0] == "run_start" and kinds[-1] == "run_end"
        assert kinds.count("round_metrics") == cfg.rounds
        assert kinds.count("eval") == cfg.rounds // cfg.eval_every
        assert kinds.count("profile") == (mode == "trace")
        rounds = [e for e in tel.events if e["event"] == "round_metrics"]
        assert [r["selections"] for r in rounds] == \
            [s.tolist() for s in off.selections]
        assert sum(r["upload_bytes"] for r in rounds) == off.upload_bytes
        assert sum(r["utility_evals"] for r in rounds) == off.shapley_evals
        if mode == "live":
            taps = [e for e in tel.events if e["event"] == "round_tap"]
            assert len(taps) == cfg.rounds
            assert {e["round"] for e in taps} == set(range(cfg.rounds))
            assert all(e["origin"] == "device" for e in taps)
            assert [e["selections"] for e in taps] == \
                [s.tolist() for s in off.selections]
            np.testing.assert_array_equal(
                [e["sv"] for e in taps], [r["sv"] for r in rounds])


def test_run_end_and_compile_on_the_cpu():
    """On the CPU nothing is built or captured: compile seconds are 0, and
    `FLResult.compile_time_s` with them; run_end carries the run."""
    tel = Telemetry()
    res = run_federated(_cfg(engine="batched"), model=_model(), device="cpu",
                        telemetry=tel)
    (comp,) = [e for e in tel.events if e["event"] == "compile"]
    assert comp["seconds"] == 0.0 == res.compile_time_s
    end = tel.events[-1]
    assert end["rounds"] == SLICE["rounds"] and end["dispatches"] == \
        res.dispatches
    assert end["upload_bytes"] == res.upload_bytes
    assert end["sv_truncation_rate"] is not None
    start = tel.events[0]
    assert start["kind"] == "solo" and start["engine"] == "batched"
    prov = start["provenance"]
    assert prov["backend"] == "cpu" and prov["device_name"] is None
    assert prov["torch_version"] == torch.__version__


def test_replicated_streams_each_seed():
    tel = Telemetry()
    reps = run_federated_replicated(_cfg(engine="batched", selector="fedavg"),
                                    (0, 1), model=_model(), device="cpu",
                                    telemetry=tel)
    assert len(reps) == 2 and _kinds(tel.events).count("run_start") == 2
    validate_events(tel.events)


# ---- the reference's stream ----------------------------------------------

def _both_streams(**over):
    kw = {**SLICE, "engine": "scan", "upload_codec": "quant8_topk", **over}
    jax_kw = dict(kw)
    if "faults" in kw:
        jax_kw["faults"] = JaxFaultSpec(**kw["faults"]._asdict())
    jax_model = jax_make_mlp(784, (16,), 10)
    want_tel, got_tel = JaxTelemetry(), Telemetry()
    want = jax_run_federated(JaxFLConfig(client=JaxClientConfig(**CLIENT),
                                         **jax_kw), model=jax_model,
                             telemetry=want_tel)
    got = run_federated(FLConfig(client=ClientConfig(**CLIENT), **kw),
                        model=_model(), device="cpu",
                        draws=JaxReplayDraws(kw["seed"], jax_model,
                                             kw["rounds"], kw["m"]),
                        telemetry=got_tel)
    return got, want, got_tel.events, want_tel.events


EXACT = {
    "run_start": ("kind", "engine", "selector", "n_clients", "m",
                  "rounds", "seed", "eval_every"),
    "round_metrics": ("round", "selections", "epochs", "utility_evals",
                      "sv_truncated", "upload_bytes", "download_bytes",
                      "quarantined"),
    "eval": ("round",),
    "run_end": ("rounds", "utility_evals", "upload_bytes", "download_bytes",
                "sv_truncation_rate"),
}
CLOSE = {"round_metrics": ("sv",), "eval": ("test_acc", "val_loss"),
         "run_end": ("final_acc",)}


@pytest.mark.parametrize("over", [
    {}, {"faults": FaultSpec(), "quarantine": True}], ids=["clean",
                                                          "hardened"])
def test_stream_matches_the_reference(over):
    """The port's scan stream on the reference's draws, event for event:
    counts, selections, epochs, bytes, eval rounds and quarantined counts
    exact; SVs, accuracies and losses at 1e-4; times, run ids,
    provenance, compile seconds and cost cards not compared.  Each
    package's validator accepts the other's stream."""
    got, want, ev_got, ev_want = _both_streams(**over)
    assert _kinds(ev_got) == _kinds(ev_want)
    for g, w in zip(ev_got, ev_want):
        kind = g["event"]
        for f in EXACT.get(kind, ()):
            assert g.get(f) == w.get(f), (kind, f, g.get(f), w.get(f))
        for f in CLOSE.get(kind, ()):
            if w.get(f) is None:
                assert g.get(f) is None, (kind, f)
            else:
                np.testing.assert_allclose(g[f], w[f], atol=1e-4,
                                           err_msg=f"{kind}.{f}")
    assert jax_validate(ev_got) == len(ev_got)
    assert validate_events(ev_want) == len(ev_want)
    assert got.quarantined_total == want.quarantined_total


# ---- the validators, report, merge and regress, side by side -------------

def _stream(*payloads):
    """A well-formed envelope chain around the payloads."""
    return [dict({"v": SCHEMA_VERSION, "seq": i, "t_s": float(i)}, **p)
            for i, p in enumerate(payloads)]


_RM = {"event": "round_metrics", "selections": [0], "epochs": [1],
       "utility_evals": 0, "sv_truncated": False, "upload_bytes": 0,
       "download_bytes": 0}


def _broken_seq():
    ev = _stream({"event": "run_start", "run_id": "r", "kind": "solo"},
                 {"event": "run_end", "wall_time_s": 1.0})
    ev[1]["seq"] = 5
    return ev


def _skewed_version():
    ev = _stream({"event": "run_end", "wall_time_s": 1.0})
    ev[0]["v"] = SCHEMA_VERSION + 1
    return ev


STREAMS = {
    "well_formed": (True, lambda: _stream(
        {"event": "run_start", "run_id": "r0", "kind": "solo"},
        dict(_RM, round=0), dict(_RM, round=1),
        {"event": "run_end", "wall_time_s": 1.0})),
    "unknown_event": (False, lambda: _stream({"event": "made_up"})),
    "missing_field": (False, lambda: _stream(
        {"event": "eval", "round": 0, "test_acc": 0.5})),
    "version_skew": (False, _skewed_version),
    "no_envelope": (False, lambda: [{"event": "run_end",
                                     "wall_time_s": 1.0}]),
    "broken_seq": (False, _broken_seq),
    "round_repeats_in_a_cell": (False, lambda: _stream(
        dict(_RM, round=1, cell=0), dict(_RM, round=1, cell=0))),
    "cells_count_apart": (True, lambda: _stream(
        dict(_RM, round=1, cell=0), dict(_RM, round=1, cell=1))),
    "run_start_resets": (True, lambda: _stream(
        {"event": "run_start", "run_id": "a", "kind": "solo"},
        dict(_RM, round=1),
        {"event": "run_start", "run_id": "b", "kind": "solo"},
        dict(_RM, round=1))),
    "taps_unordered": (True, lambda: _stream(
        {"event": "round_tap", "round": 3}, {"event": "round_tap",
                                             "round": 1})),
}


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_validators_agree(name):
    ok, make = STREAMS[name]
    if ok:
        assert validate_events(make()) == jax_validate(make()) == len(make())
    else:
        with pytest.raises(TelemetryError):
            validate_events(make())
        with pytest.raises(JaxTelemetryError):
            jax_validate(make())


def test_emit_sanitizes_and_refuses_what_the_reference_refuses(tmp_path):
    path = str(tmp_path / "ev.jsonl")
    with Telemetry(path) as tel:
        tel.emit("run_start", run_id=tel.run_id, kind="solo")
        tel.emit("round_metrics", round=np.int64(0),
                 selections=torch.arange(3), epochs=np.ones(3, np.int32),
                 utility_evals=torch.tensor(7, dtype=torch.int32),
                 sv_truncated=np.bool_(False), upload_bytes=0,
                 download_bytes=0, sv=torch.tensor([0.5, -1.0, 2.0]))
    back = read_events(path)
    assert back == tel.events
    assert back[1]["selections"] == [0, 1, 2] and back[1]["sv"] == \
        [0.5, -1.0, 2.0] and back[1]["utility_evals"] == 7
    for bad in (lambda t: t.emit("made_up"), lambda t: t.emit("compile")):
        with pytest.raises(TelemetryError):
            bad(Telemetry())
        with pytest.raises(JaxTelemetryError):
            bad(JaxTelemetry())


def test_emit_keeps_seq_gap_free_across_threads():
    """The live tap's thread emits beside the main thread."""
    import threading
    tel = Telemetry()

    def burst():
        for i in range(200):
            tel.emit("round_tap", round=i)

    threads = [threading.Thread(target=burst) for _ in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert [e["seq"] for e in tel.events] == list(range(800))
    assert validate_events(tel.events) == 800


def test_report_and_merge_agree_with_the_reference(tmp_path):
    """`summarize`/`render_table`, `merge_streams` and the report CLI give
    the reference's results on the same streams."""
    tel = Telemetry()
    run_federated(_cfg(engine="scan"), model=_model(), device="cpu",
                  telemetry=tel)
    shard = tel.events
    assert report.summarize(shard) == jax_report.summarize(shard)
    assert report.render_table(report.summarize(shard)) == \
        jax_report.render_table(jax_report.summarize(shard))
    shifted = [dict(e, t_s=e["t_s"] + 0.5) for e in shard]
    assert merge.merge_streams([shard, shifted]) == \
        jax_merge.merge_streams([shard, shifted])
    assert merge.merge_streams([shard]) == shard
    assert merge.shard_run_ids(shard) == jax_merge.shard_run_ids(shard)
    path = tmp_path / "ev.jsonl"
    path.write_text("".join(json.dumps(e) + "\n" for e in shard)
                    + '{"v": 1, "se')
    got, cut = telemetry.read_events_prefix(str(path))
    assert (got, cut) == jax_merge.read_events_prefix(str(path))
    assert cut is not None and got == shard


@pytest.fixture
def test_schema(monkeypatch):
    """One bench schema registered in both packages' WATCHED tables."""
    metrics = [("e2e_us.off", "lower", 0.75, None),
               ("overhead_pct.host", "lower", None, 3.0),
               ("rows[1].count", "higher", 0.0, None)]
    for mod in (regress, jax_regress):
        monkeypatch.setitem(mod.WATCHED, "bench_torch_test/v1", tuple(
            mod.Metric(p, d, rel_tol=r, abs_tol=a) for p, d, r, a in metrics))
    return "bench_torch_test/v1"


@pytest.mark.parametrize("current", [
    {"e2e_us": {"off": 110.0}, "overhead_pct": {"host": 1.0},
     "rows": [{}, {"count": 4}]},
    {"e2e_us": {"off": 190.0}, "overhead_pct": {"host": 4.5},
     "rows": [{}, {"count": 3}]},
    {"e2e_us": {}, "rows": []}], ids=["pass", "regressed", "missing"])
def test_regress_agrees_with_the_reference(test_schema, tmp_path, current):
    base = {"schema": test_schema, "e2e_us": {"off": 100.0},
            "overhead_pct": {"host": 1.0}, "rows": [{}, {"count": 4}]}
    cur = dict(current, schema=test_schema)
    got = regress.compare_bench(test_schema, cur, base)
    assert got == jax_regress.compare_bench(test_schema, cur, base)
    for m in regress.WATCHED[test_schema]:
        assert regress.check_metric(m, cur, base) == jax_regress.check_metric(
            jax_regress.Metric(*m), cur, base)
    # run_check sweeps only BENCH_torch_*.json: the reference's names and
    # baselines are never read
    bench, baselines = tmp_path / "bench", tmp_path / "baselines"
    bench.mkdir()
    baselines.mkdir()
    (bench / "BENCH_torch_test.json").write_text(json.dumps(cur))
    (bench / "BENCH_test.json").write_text(json.dumps(cur))
    (baselines / "BENCH_torch_test.json").write_text(json.dumps(base))
    entry = regress.run_check(str(bench), str(baselines), None)
    assert list(entry["benches"]) == ["BENCH_torch_test.json"]
    assert entry["benches"]["BENCH_torch_test.json"]["metrics"] == got
    assert entry["status"] == ("regressed" if any(
        m["status"] == "regressed" for m in got) else "pass")
    traj = str(tmp_path / "BENCH_torch_trajectory.json")
    regress.append_trajectory(traj, entry)
    ledger = json.loads(open(traj).read())
    assert ledger["schema"] == regress.TRAJECTORY_SCHEMA
    assert len(ledger["entries"]) == 1 and "provenance" in ledger


def test_regress_defaults_name_only_the_ports_files():
    assert regress.WATCHED == {}
    assert regress.BENCH_GLOB == "BENCH_torch_*.json"
    assert regress.TRAJECTORY_NAME == "BENCH_torch_trajectory.json"
    assert not os.path.exists(regress.DEFAULT_BASELINES)
    with pytest.raises(ValueError, match="schema"):
        telemetry.write_bench_json("unused.json", {})


# ---- the grid ------------------------------------------------------------

def _grid_spec():
    base = _cfg(engine="scan", selector="greedyfed")
    return GridSpec.product(base, selectors=["greedyfed", "fedavg"],
                            seeds=[0])


def _grid(spec, **kw):
    return run_grid(spec, model=_model(), device="cpu", **kw)


def test_grid_kill_resume_with_telemetry(tmp_path):
    """A sink-observed segmented grid, killed after one segment and
    resumed, equals the unobserved unsegmented grid bit for bit; the
    segment, checkpoint and per-cell streams flow and validate."""
    spec = _grid_spec()
    ref = _grid(spec)
    path = str(tmp_path / "events.jsonl")
    ckpt = str(tmp_path / "ckpt")
    with Telemetry(path, heartbeat_every_s=1e9, live_tap=True) as tel:
        assert _grid(spec, rounds_per_segment=2, checkpoint_dir=ckpt,
                     max_segments=1, telemetry=tel) is None
        resumed = _grid(spec, rounds_per_segment=2, checkpoint_dir=ckpt,
                        telemetry=tel, compile_stats=True)
    for a, b in zip(resumed.results, ref.results):
        for x, y in zip(a.selections, b.selections):
            np.testing.assert_array_equal(x, y)
        assert a.test_acc == b.test_acc and a.upload_bytes == b.upload_bytes
        np.testing.assert_array_equal(a.sv_final, b.sv_final)
        for x, y in zip(tree_leaves(a.params), tree_leaves(b.params)):
            assert torch.equal(x, y)
    events = read_events(path)
    assert validate_events(events) == len(events)
    assert jax_validate(events) == len(events)
    kinds = _kinds(events)
    assert kinds.count("run_start") == 2
    assert "checkpoint_save" in kinds and "checkpoint_load" in kinds
    assert kinds.count("segment_end") == kinds.count("segment_start")
    saves = [e for e in events if e["event"] == "checkpoint_save"]
    assert all(e["nbytes"] > 0 and e["path"].endswith(".npz") for e in saves)
    per_cell = {}
    for e in events:
        if e["event"] == "round_metrics":
            per_cell.setdefault(e["cell"], []).append(e["round"])
    assert per_cell[0] == per_cell[1] == list(range(SLICE["rounds"]))
    # taps of the rounds run: 2 before the kill (cell 0's first segment),
    # 2 + 4 after it (cell 0's second segment, cell 1's two)
    assert kinds.count("round_tap") == 8
    card = resumed.partitions[0].cost_card
    assert card["flops"] > 0 and resumed.partitions[0].peak_bytes is None
    assert resumed.partitions[0].flops_per_dispatch == 2 * card["flops"]
    assert events[-1]["event"] == "run_end"
    assert jax_report.summarize(events) == report.summarize(events)


def test_grid_corrupt_checkpoint_and_failed_cells_are_streamed(tmp_path,
                                                              monkeypatch):
    spec = _grid_spec()
    ckpt = str(tmp_path)
    _grid(spec, rounds_per_segment=2, checkpoint_dir=ckpt)
    bad = os.path.join(ckpt, "p1-seg0001.npz")
    with open(bad, "r+b") as f:
        f.truncate(os.path.getsize(bad) // 3)
    tel = Telemetry()
    _grid(spec, rounds_per_segment=2, checkpoint_dir=ckpt, telemetry=tel)
    (corrupt,) = [e for e in tel.events if e["event"] == "checkpoint_corrupt"]
    assert corrupt["path"] == bad and corrupt["segment"] == 1

    real = runner.run_segments

    def sabotage(model, ccfg, scan_spec, batch, **kw):
        if kw.get("tag") == "p0-":
            raise RuntimeError("injected partition failure")
        return real(model, ccfg, scan_spec, batch, **kw)

    monkeypatch.setattr(runner, "run_segments", sabotage)
    tel = Telemetry()
    grid = _grid(spec, telemetry=tel)
    failed = [e for e in tel.events if e["event"] == "cell_failed"]
    assert [e["cell"] for e in failed] == [f.cell for f in grid.failures]
    assert len(failed) == 1 and "injected" in failed[0]["error"]
    validate_events(tel.events)


# ---- profile window and cost card ----------------------------------------

def test_trace_capture_without_trace_dir_is_a_no_op():
    tel = Telemetry()
    with profile.trace_capture(tel, "x") as rec:
        assert rec is None
    with profile.trace_capture(None, "x") as rec:
        assert rec is None
    assert tel.events == []


def test_trace_capture_on_the_cpu_loop_engine(tmp_path):
    """The loop engine's window exports a Chrome trace whose `repro.*`
    spans give the stage seconds (source "trace"), under the reference's
    stage names."""
    tel = Telemetry(trace_dir=str(tmp_path))
    run_federated(_cfg(), model=_model(), device="cpu", telemetry=tel)
    (prof,) = [e for e in tel.events if e["event"] == "profile"]
    assert prof["source"] == "trace" and prof["captured"]
    assert prof["trace_dir"] == os.path.join(str(tmp_path), tel.run_id)
    assert set(jax_trace.STAGES) <= set(prof["stage_wall_s"]) <= \
        set(trace.STAGES)
    assert all(v > 0 for v in prof["stage_wall_s"].values())
    # a window inside a running profiler degrades to host spans
    with torch.profiler.profile():
        inner = Telemetry(trace_dir=str(tmp_path))
        with profile.trace_capture(inner, "inner"):
            with trace.stage("train"):
                pass
    (prof,) = inner.events
    assert prof["source"] == "host" and not prof["captured"]
    assert set(prof["stage_wall_s"]) == {"train"}


def test_cost_card_counts_the_rounds_matrix_products():
    """The scan round's card on the 784-16-10 MLP: FLOPs of training (M
    clients, E * B steps of a 16-row batch: forward, weight gradients and
    the hidden layer's input gradient) plus the GTG-Shapley utilities
    (R * M prefix models and the two end points, each on the validation
    rows); the eval's are the test and validation forwards."""
    per_row = 2 * (784 * 16 + 16 * 10)
    m, steps, batch, walks = SLICE["m"], 4, 16, SLICE["shapley_max_iters"]
    train = m * steps * (2 * batch * per_row + 2 * batch * 16 * 10)
    utility = (walks * m + 2) * SLICE["n_val"] * per_row
    evals = (SLICE["n_test"] + SLICE["n_val"]) * per_row
    before = len(profile._CARD_CACHE)
    cards = []
    for _ in range(2):
        tel = Telemetry()
        run_federated(_cfg(engine="scan", seed=11), model=_model(),
                      device="cpu", telemetry=tel)
        (comp,) = [e for e in tel.events if e["event"] == "compile"]
        cards.append(comp["cost_card"])
    card = cards[0]
    assert card["flops"] == train + utility and card["eval_flops"] == evals
    assert card["peak_bytes"] is None and card["kernel_launches"] is None
    assert card["roofline"]["compute_s"] == card["flops"] / 67e12
    assert card["roofline"]["lacks"] == "bytes_accessed"
    assert cards[1] == card and len(profile._CARD_CACHE) <= before + 1

    calls = []

    def fn(x):
        calls.append(1)
        return x @ x

    x = torch.ones((8, 8))
    first = profile.cached_cost_card(fn, x)
    assert profile.cached_cost_card(fn, x) is first and len(calls) == 1
    assert first["flops"] == 2 * 8 * 8 * 8


def test_compile_timer_accumulates_what_is_reported():
    with telemetry.CompileTimer() as outer:
        trace.add_compile_seconds(0.25)
        with telemetry.CompileTimer() as inner:
            trace.add_compile_seconds(0.5)
    trace.add_compile_seconds(1.0)          # no timer active: nobody sees it
    assert outer.seconds == 0.75 and inner.seconds == 0.5


def test_package_surface_matches_the_reference():
    import repro.telemetry as jax_tel
    assert telemetry.__all__ == jax_tel.__all__
    assert telemetry.SCHEMA_VERSION == jax_tel.SCHEMA_VERSION
    from repro.telemetry.events import REQUIRED_FIELDS as want
    from repro_torch.telemetry.events import REQUIRED_FIELDS as got
    assert got == want


def test_serve_streams_a_serve_run():
    """`serve_requests` with a sink: the reference example's stream (kind
    "serve", one `serve_step` a decode step, the request SVs as one
    `round_metrics`), and the outputs of the run without one."""
    from repro_torch.configs import get_config
    from repro_torch.models.lm import model as TM
    from repro_torch.serve import serve_requests
    cfg = get_config("tinyllama_1_1b").reduced()
    params = TM.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 16),
                           generator=torch.Generator().manual_seed(1))
    off = serve_requests(cfg, params, tokens, 3, device="cpu")
    tel = Telemetry()
    on = serve_requests(cfg, params, tokens, 3, device="cpu", telemetry=tel)
    assert torch.equal(on.generated, off.generated)
    assert torch.equal(on.sv, off.sv)
    assert _kinds(tel.events) == ["run_start"] + ["serve_step"] * 3 + [
        "compile", "round_metrics", "run_end"]
    assert tel.events[0]["kind"] == "serve"
    assert tel.events[4]["cost_card"]["flops"] > 0
    assert validate_events(tel.events) == jax_validate(tel.events)
    (row,) = report.summarize(tel.events)
    assert row == jax_report.summarize(tel.events)[0]
    assert row["kind"] == "serve" and row["utility_evals"] == 4
