"""repro_torch.checkpoint, repro_torch.grid and engine/replicated.py on the
CPU, against the port's solo runs and the reference's `run_grid`.

Tolerances: every grid cell is held bitwise to the port's solo
`run_federated(engine="scan")` at that cell's config (selections, params,
SVs, bytes, Shapley evals, eval history, quarantined counts); a segmented
grid, a killed-and-resumed grid and a grid resumed past a corrupt snapshot
bitwise to the whole grid; the replicated batched engine bitwise to the
solo batched runs.  Checkpoints roundtrip bit for bit, and their digests
equal the reference's hashing of the same arrays.  Against the
reference's own `run_grid` (the port fed the reference's draws through
`JaxReplayDraws`, one source a cell) selections and bytes are equal and
floats agree at 1e-4, the bound `tests/test_torch_scan.py` holds the solo
scans to.  Runs use the 784-16-10 MLP with N = 6, M = 3 and at most 4
rounds, so the file stays short under the suite's parallel workers.
"""
import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.ckpt import _digest as jax_digest
from repro.core.selection_jax import make_selector_spec as jax_selector_spec
from repro.federated.client import ClientConfig as JaxClientConfig
from repro.federated.server import FLConfig as JaxFLConfig
from repro.grid import GridSpec as JaxGridSpec
from repro.grid import run_grid as jax_run_grid
from repro.grid.partition import interleave as jax_interleave
from repro.grid.partition import partition_cells as jax_partition_cells
from repro.models.mlp_cnn import make_mlp as jax_make_mlp
from repro_torch.checkpoint import (
    CheckpointCorruptError, load_carry, load_pytree, load_server_state,
    save_carry, save_pytree, save_server_state,
)
from repro_torch.checkpoint.ckpt import _digest
from repro_torch.core.selection import make_selector_spec
from repro_torch.federated.client import ClientConfig
from repro_torch.federated.draws import TorchDraws
from repro_torch.federated.server import (
    FLConfig, run_federated, run_federated_replicated,
)
from repro_torch.grid import CellFailure, GridCell, GridSpec, run_grid
from repro_torch.grid import runner
from repro_torch.grid.partition import interleave, partition_cells
from repro_torch.grid.segments import segment_plan
from repro_torch.models.mlp_cnn import make_mlp
from repro_torch.tree import tree_leaves
from test_torch_server import JaxReplayDraws

SLICE = dict(n_clients=6, m=3, rounds=4, n_train=600, n_val=100, n_test=100,
             eval_every=2, shapley_max_iters=6, engine="scan")
CLIENT = dict(epochs=2, batches_per_epoch=2, batch_size=16)
MODEL = make_mlp(784, (16,), 10)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs six test files at once; at these small sizes torch's
    intra-op threads only contend for the cores (a grid test took 28 s
    with 8 threads beside a busy machine, 1 s with one)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _base(**over):
    return FLConfig(client=ClientConfig(**CLIENT), **{**SLICE, **over})


# greedyfed, fedavg and power_of_choice x seeds (0, 1), one quant8_topk
# override (a codec partition) and one eval_every override
CELLS = (GridCell("greedyfed", 0), GridCell("greedyfed", 1),
         GridCell("greedyfed", 1, {"upload_codec": "quant8_topk"}),
         GridCell("fedavg", 0), GridCell("fedavg", 1),
         GridCell("power_of_choice", 0),
         GridCell("power_of_choice", 1, {"eval_every": 3}))
SPEC = GridSpec(_base(), CELLS)


def _grid(spec=SPEC, **kw):
    return run_grid(spec, model=MODEL, device="cpu", **kw)


def _assert_bitwise(got, want):
    assert len(got.selections) == len(want.selections)
    for a, b in zip(got.selections, want.selections):
        np.testing.assert_array_equal(a, b)
    assert got.upload_bytes == want.upload_bytes
    assert got.download_bytes == want.download_bytes
    assert got.shapley_evals == want.shapley_evals
    assert got.quarantined_total == want.quarantined_total
    assert got.test_acc == want.test_acc and got.val_loss == want.val_loss
    np.testing.assert_array_equal(got.sv_final, want.sv_final)
    np.testing.assert_array_equal(got.selection_counts,
                                  want.selection_counts)
    for a, b in zip(tree_leaves(got.params), tree_leaves(want.params)):
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def whole():
    return _grid()


# ------------------------------------------------------------ checkpoint --
def _tree():
    gen = torch.Generator().manual_seed(3)
    torch.rand((7,), generator=gen)
    return {"params": {"w": torch.randn((4, 3)), "b": torch.randn((3,))},
            "counts": torch.arange(6, dtype=torch.int64),
            "mask": torch.tensor([True, False, True]),
            "half": torch.randn((5,)).to(torch.bfloat16),
            "pair": (torch.zeros((2,), dtype=torch.int32), np.ones((2, 2))),
            "gen": gen.get_state()}


def test_checkpoint_roundtrip_is_bitwise(tmp_path):
    tree = _tree()
    path = str(tmp_path / "ck")
    save_pytree(path, tree)
    got = load_pytree(path, _tree())
    for a, b in zip(tree_leaves(got), tree_leaves(tree)):
        if isinstance(a, tuple):
            assert torch.equal(a[0], b[0]) and a[0].dtype == torch.int32
            assert isinstance(a[1], np.ndarray)
            np.testing.assert_array_equal(a[1], b[1])
        else:
            assert a.dtype == b.dtype and torch.equal(a, b)
    gen = torch.Generator()
    gen.set_state(got["gen"])
    want = torch.Generator().manual_seed(3)
    torch.rand((7,), generator=want)
    assert torch.equal(torch.rand((5,), generator=gen),
                       torch.rand((5,), generator=want))


def test_checkpoint_structure_mismatch_raises(tmp_path):
    path = str(tmp_path / "ck")
    save_pytree(path, _tree())
    with pytest.raises(ValueError, match="structure mismatch"):
        load_pytree(path, {**_tree(), "extra": torch.zeros(1)})
    with pytest.raises(ValueError, match="shape mismatch"):
        load_pytree(path, {**_tree(), "mask": torch.zeros((4,), dtype=bool)})


def test_atomic_write_leaves_no_tmp_and_stamps_digests(tmp_path):
    tree = _tree()
    save_pytree(str(tmp_path / "ck.npz"), tree)
    assert sorted(os.listdir(tmp_path)) == ["ck.manifest.json", "ck.npz"]
    with open(tmp_path / "ck.manifest.json") as f:
        manifest = json.load(f)
    npz = np.load(tmp_path / "ck.npz")
    assert sorted(manifest["digests"]) == sorted(npz.files)
    for key in npz.files:
        assert manifest["digests"][key] == _digest(npz[key])
    np.testing.assert_array_equal(npz["counts"], np.arange(6))


@pytest.mark.parametrize("damage", ["truncate", "tamper"])
def test_corrupt_checkpoint_raises(tmp_path, damage):
    path = str(tmp_path / "ck")
    save_pytree(path, _tree())
    if damage == "truncate":
        with open(path + ".npz", "r+b") as f:
            f.truncate(os.path.getsize(path + ".npz") // 2)
    else:
        with open(path + ".manifest.json") as f:
            manifest = json.load(f)
        manifest["digests"]["counts"] = "0" * 64
        with open(path + ".manifest.json", "w") as f:
            json.dump(manifest, f)
    with pytest.raises(CheckpointCorruptError):
        load_pytree(path, _tree())
    with pytest.raises(FileNotFoundError):       # missing is not corrupt
        load_pytree(str(tmp_path / "absent"), _tree())


@pytest.mark.parametrize("arr", [
    np.linspace(-1, 1, 12, dtype=np.float32).reshape(3, 4),
    np.arange(9, dtype=np.int64), np.array([True, False, True]),
    np.zeros((0, 2), np.int32)])
def test_digest_equals_the_reference(arr):
    assert _digest(arr) == jax_digest(arr)


def test_carry_brings_its_draw_sources_back(tmp_path):
    """The port's stand-in for the reference's key in the carry: the draw
    sources' states are saved beside it and put back on load."""
    draws = [TorchDraws(0, "cpu"), TorchDraws(1, "cpu")]
    for d in draws:
        torch.rand((3,), generator=d.gen)
    carry = {"w": torch.randn((2, 2))}
    save_carry(str(tmp_path / "c"), carry, draws)
    want = [torch.rand((4,), generator=d.gen) for d in draws]
    fresh = [TorchDraws(0, "cpu"), TorchDraws(1, "cpu")]
    got = load_carry(str(tmp_path / "c"), {"w": torch.zeros((2, 2))}, fresh)
    assert torch.equal(got["w"], carry["w"])
    for d, w in zip(fresh, want):
        assert torch.equal(torch.rand((4,), generator=d.gen), w)
    params = {"layer0": {"w": torch.randn((3, 2))}}
    save_server_state(str(tmp_path / "s"), params=params,
                      sv=torch.arange(4.0), counts=np.arange(4),
                      round_idx=7, seed=2)
    state = load_server_state(str(tmp_path / "s"),
                              {"layer0": {"w": torch.zeros((3, 2))}})
    assert torch.equal(state["params"]["layer0"]["w"], params["layer0"]["w"])
    assert state["round"] == 7 and state["seed"] == 2
    np.testing.assert_array_equal(state["sv"], np.arange(4.0))
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]


# ------------------------------------------------------ spec, partition --
@pytest.mark.parametrize("names,codecs", [
    (["greedyfed", "fedavg", "power_of_choice", "ucb", "random"], None),
    (["greedyfed", "s_fedavg", "greedyfed", "fedavg"],
     ["quant8", "identity", "quant8", "topk"]),
    (["greedyfed_dropout", "power_of_choice", "fedprox", "ucb"],
     ["identity", "quant8_topk", "identity", "quant8_topk"])])
def test_partitions_are_the_reference_partitions(names, codecs):
    ours = partition_cells([make_selector_spec(n, 6, 3) for n in names],
                           codecs)
    ref = jax_partition_cells([jax_selector_spec(n, 6, 3) for n in names],
                              codecs)
    assert [p.key.label for p in ours] == [p.key.label for p in ref]
    assert [tuple(p.key) for p in ours] == [tuple(p.key) for p in ref]
    assert [p.cell_indices for p in ours] == [p.cell_indices for p in ref]
    assert [p.strategy_ids for p in ours] == [p.strategy_ids for p in ref]
    assert ([[s.name for s in p.specs] for p in ours]
            == [[s.name for s in p.specs] for p in ref])
    per = [[f"r{i}" for i in p.cell_indices] for p in ours]
    assert (interleave(len(names), ours, per)
            == jax_interleave(len(names), ref, per))


def test_invalid_grids_are_rejected_before_anything_runs():
    with pytest.raises(ValueError, match="static FLConfig field 'n_clients'"):
        _grid(GridSpec(_base(), (GridCell("fedavg", 0), GridCell(
            "fedavg", 1, {"n_clients": 8}))))
    with pytest.raises(ValueError, match="unknown upload_codec"):
        _grid(GridSpec(_base(), (GridCell("fedavg", 0,
                                          {"upload_codec": "zip"}),)))
    with pytest.raises(ValueError, match="must divide"):
        _grid(GridSpec.product(_base(), seeds=(0,)), rounds_per_segment=3)
    assert segment_plan(4, 0) == (4, 1) and segment_plan(4, 2) == (2, 2)
    spec = GridSpec.product(_base(), ["greedyfed", "fedavg"], (0, 1))
    assert [(c.selector, c.seed) for c in spec.cells] == [
        ("greedyfed", 0), ("greedyfed", 1), ("fedavg", 0), ("fedavg", 1)]


# --------------------------------------------------------- grid vs solo --
@pytest.mark.parametrize("i", range(len(CELLS)))
def test_grid_cell_is_bitwise_its_solo_scan_run(whole, i):
    solo = run_federated(CELLS[i].config(SPEC.base), model=MODEL,
                         device="cpu")
    _assert_bitwise(whole.results[i], solo)
    assert whole.results[i].config == solo.config


def test_grid_partitions_and_replays(whole):
    """One replica step a partition, one round replay a round for all its
    replicas, and the evals where any replica's cadence is set."""
    assert [p.label for p in whole.partitions] == [
        "sv", "sv+quant8_topk", "plain", "losses"]
    assert [p.cell_indices for p in whole.partitions] == [
        (0, 1), (2,), (3, 4), (5, 6)]
    assert [p.replays for p in whole.partitions] == [
        {"round": 4, "eval": 2}] * 3 + [{"round": 4, "eval": 3}]
    assert [len(r.test_acc) for r in whole.results] == [2] * 6 + [2]
    assert [t for t, _ in whole.results[6].test_acc] == [3, 4]
    assert all(p.graph_launches is None for p in whole.partitions)  # CPU
    assert whole.n_segments == 1 and not whole.failures
    assert whole.results[3].shapley_evals == 0
    assert whole.partitions[0].shapley_evals > 0


def test_segmented_grid_is_bitwise_the_whole_grid(whole):
    seg = _grid(rounds_per_segment=2)
    assert seg.n_segments == 2
    for a, b in zip(seg.results, whole.results):
        _assert_bitwise(a, b)
    assert [p.dispatches for p in seg.partitions] == [2] * 4


def test_kill_and_resume_is_bitwise(whole, tmp_path):
    ckpt = str(tmp_path)
    assert _grid(rounds_per_segment=2, checkpoint_dir=ckpt,
                 max_segments=1) is None
    assert os.listdir(ckpt) and "p0-seg0000.npz" in os.listdir(ckpt)
    resumed = _grid(rounds_per_segment=2, checkpoint_dir=ckpt)
    for a, b in zip(resumed.results, whole.results):
        _assert_bitwise(a, b)
    # the first partition ran one segment before the kill
    assert [p.dispatches for p in resumed.partitions] == [1, 2, 2, 2]
    assert len(resumed.results[0].round_time_s) == SLICE["rounds"]


def test_corrupt_segment_falls_back_and_stays_bitwise(whole, tmp_path):
    ckpt = str(tmp_path)
    _grid(rounds_per_segment=2, checkpoint_dir=ckpt)
    bad = os.path.join(ckpt, "p1-seg0001.npz")
    with open(bad, "r+b") as f:
        f.truncate(os.path.getsize(bad) // 3)
    resumed = _grid(rounds_per_segment=2, checkpoint_dir=ckpt)
    for a, b in zip(resumed.results, whole.results):
        _assert_bitwise(a, b)
    assert [p.dispatches for p in resumed.partitions] == [0, 1, 0, 0]
    again = _grid(rounds_per_segment=2, checkpoint_dir=ckpt)   # rewritten
    assert [p.dispatches for p in again.partitions] == [0, 0, 0, 0]
    _assert_bitwise(again.results[2], whole.results[2])


def test_fingerprint_and_format_mismatch_raise(tmp_path):
    spec = GridSpec.product(_base(), ["fedavg"], (0,))
    ckpt = str(tmp_path)
    _grid(spec, rounds_per_segment=2, checkpoint_dir=ckpt)
    other = GridSpec.product(_base(privacy_sigma=0.1), ["fedavg"], (0,))
    with pytest.raises(ValueError, match="DIFFERENT grid"):
        _grid(other, rounds_per_segment=2, checkpoint_dir=ckpt)
    assert _grid(other, rounds_per_segment=2, checkpoint_dir=ckpt,
                 resume=False) is not None
    # a directory the reference wrote (its format 4, no package) is refused
    with open(os.path.join(ckpt, "grid.json"), "w") as f:
        json.dump({"fingerprint": "x", "carry_format": 4}, f)
    with pytest.raises(ValueError, match="carry format 4 of package 'repro'"):
        _grid(other, rounds_per_segment=2, checkpoint_dir=ckpt)


def test_failing_partition_degrades_to_cell_failures(whole, monkeypatch):
    real = runner.run_segments

    def sabotage(model, ccfg, scan_spec, batch, **kw):
        if kw.get("tag") == "p0-":
            raise RuntimeError("injected partition failure")
        return real(model, ccfg, scan_spec, batch, **kw)

    monkeypatch.setattr(runner, "run_segments", sabotage)
    grid = _grid()
    assert [f.cell for f in grid.failures] == [0, 1]
    fail = grid.failures[0]
    assert isinstance(fail, CellFailure) and fail.partition == "sv"
    assert "injected partition failure" in fail.error
    assert "RuntimeError" in fail.traceback
    assert np.isnan(fail.final_acc) and fail.upload_bytes == 0
    for i in range(2, len(CELLS)):
        _assert_bitwise(grid.results[i], whole.results[i])
    assert set(grid.acc_summary()) == {"greedyfed", "fedavg",
                                       "power_of_choice"}
    assert grid.partitions[0].dispatches == 0
    with pytest.raises(RuntimeError, match="injected"):
        _grid(isolate_cells=False)


@pytest.mark.parametrize("retries", [0, 1])
def test_a_failed_segment_is_retried_from_its_start(whole, monkeypatch,
                                                    retries):
    """A segment that raises once is staged again from the same carries
    and draws: with a retry the grid is bitwise the whole grid, without
    one the partition fails."""
    from repro_torch.grid import segments
    real, calls = segments._replay_segment, []

    def flaky(step, *args):
        out = real(step, *args)
        calls.append(step)
        if len(calls) == 2:     # the first partition's second segment,
            raise RuntimeError("injected segment failure")   # replayed
        return out

    monkeypatch.setattr(segments, "_replay_segment", flaky)
    grid = _grid(rounds_per_segment=2, retries=retries,
                 retry_backoff_s=0.0)
    if retries:
        assert not grid.failures
        for a, b in zip(grid.results, whole.results):
            _assert_bitwise(a, b)
    else:
        assert [f.cell for f in grid.failures] == [0, 1]


def _raise(*args, **kwargs):
    raise AssertionError("the replica step read a tensor back to the host")


def test_replica_step_reads_nothing_back(monkeypatch):
    """A partition of two strategies (greedyfed and s_fedavg, switched by
    each replica's device strategy_id) and two eval cadences replays with
    every way of reading a tensor back to the host patched to raise, and
    each replica still makes its solo run."""
    from repro_torch.engine.round_engine import SegmentStep
    from repro_torch.federated.draws import stack_rounds
    from repro_torch.federated.server import setup_run
    cells = (GridCell("greedyfed", 0), GridCell("s_fedavg", 1,
                                                {"eval_every": 3}))
    cfgs = GridSpec(_base(), cells).validate()
    setups = [setup_run(c, model=MODEL, device="cpu") for c in cfgs]
    (part,) = partition_cells([s.sel_spec for s in setups])
    spec, batch = runner._build_batch(part, cfgs, setups, 0)
    step = SegmentStep(MODEL, cfgs[0].client, spec, list(batch.ops))
    step.stage(list(batch.carries), 0, [
        stack_rounds([s.draws.round(t, plan) for t in range(4)])
        for s, plan in zip(setups, batch.plans)])
    with monkeypatch.context() as mp:
        for name in ("item", "tolist", "cpu", "numpy", "__float__",
                     "__int__", "__bool__"):
            mp.setattr(torch.Tensor, name, _raise)
        step.replay(0, 4)
    assert step.replays == {"round": 4, "eval": 3}
    for cfg, out in zip(cfgs, step.output(4)):
        want = run_federated(cfg, model=MODEL, device="cpu")
        for t in range(4):
            np.testing.assert_array_equal(out.selections[t].numpy(),
                                          want.selections[t])
        acc = out.test_acc.numpy()
        assert [t + 1 for t in np.flatnonzero(~np.isnan(acc))] == [
            r for r, _ in want.test_acc]
        assert int(out.carry.eval_slot) == len(want.test_acc)
        for a, b in zip(tree_leaves(out.carry.params),
                        tree_leaves(want.params)):
            assert torch.equal(a, b)


# ------------------------------------------------------------ replicated --
@pytest.mark.parametrize("over", [
    {}, {"selector": "power_of_choice", "upload_codec": "quant8_topk"},
    {"selector": "ucb", "straggler_frac": 0.5, "quarantine": True}])
def test_replicated_batched_branch_is_bitwise_the_solo_runs(over):
    cfg = _base(engine="batched", **over)
    reps = run_federated_replicated(cfg, (0, 1), model=MODEL, device="cpu")
    for seed, rep in zip((0, 1), reps):
        solo = run_federated(dataclasses.replace(cfg, seed=seed),
                             model=MODEL, device="cpu")
        _assert_bitwise(rep, solo)
        assert rep.config.seed == seed
        # each replica is its own run: its own replays and round times
        assert rep.dispatches == solo.dispatches
        assert len(rep.round_time_s) == cfg.rounds
    with pytest.raises(ValueError, match="engine='scan'"):
        run_federated_replicated(cfg, (0,), device="cpu",
                                 rounds_per_segment=2)


def test_replicated_scan_branch_is_run_grid():
    cfg = _base(selector="fedavg")
    reps = run_federated_replicated(cfg, (0, 1), model=MODEL, device="cpu",
                                    selectors=["greedyfed", "fedavg"])
    assert [(r.config.selector, r.config.seed) for r in reps] == [
        ("greedyfed", 0), ("greedyfed", 1), ("fedavg", 0), ("fedavg", 1)]
    grid = _grid(GridSpec.product(cfg, ["greedyfed", "fedavg"], (0, 1)))
    for a, b in zip(reps, grid.results):
        _assert_bitwise(a, b)
    seg = run_federated_replicated(cfg, (1,), model=MODEL, device="cpu",
                                   rounds_per_segment=2)
    _assert_bitwise(seg[0], grid.results[3])


@pytest.mark.parametrize("kw,match", [
    ({"spec": GridSpec.product(_base(clients_shards=2), seeds=(0,))},
     "client-sharding slice")])
def test_later_slices_raise_not_implemented(kw, match):
    kw = {"spec": SPEC, **kw}
    with pytest.raises(NotImplementedError, match=match):
        _grid(**kw)


# ------------------------------------------------------------- reference --
def test_grid_matches_the_reference_grid():
    """greedyfed + fedavg x seeds (0, 1), T = 3: the port's run_grid on the
    reference's draws against the reference's run_grid."""
    kw = {**SLICE, "rounds": 3}
    jax_model = jax_make_mlp(784, (16,), 10)
    want = jax_run_grid(JaxGridSpec.product(
        JaxFLConfig(client=JaxClientConfig(**CLIENT), **kw),
        selectors=["greedyfed", "fedavg"], seeds=(0, 1)), model=jax_model)
    spec = GridSpec.product(FLConfig(client=ClientConfig(**CLIENT), **kw),
                            selectors=["greedyfed", "fedavg"], seeds=(0, 1))
    got = _grid(spec, draws=[JaxReplayDraws(c.seed, jax_model, kw["rounds"],
                                            kw["m"]) for c in spec.cells])
    assert ([p.label for p in got.partitions]
            == [p.label for p in want.partitions])
    for g, w in zip(got.results, want.results):
        for a, b in zip(g.selections, w.selections):
            np.testing.assert_array_equal(a, np.asarray(b))
        assert g.upload_bytes == w.upload_bytes
        assert g.download_bytes == w.download_bytes
        assert g.shapley_evals == w.shapley_evals
        assert [r for r, _ in g.test_acc] == [r for r, _ in w.test_acc]
        np.testing.assert_allclose([a for _, a in g.test_acc],
                                   [a for _, a in w.test_acc], atol=1e-4)
        np.testing.assert_allclose(g.sv_final, np.asarray(w.sv_final),
                                   atol=1e-4)
        for a, b in zip(tree_leaves(g.params), jax.tree.leaves(w.params)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)
