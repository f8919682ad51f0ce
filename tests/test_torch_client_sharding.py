"""Client-axis sharding in the port (`launch/mesh.py`, `grid/shard.py`,
the sharded `cohort_gather`, `gather_client_state`), on the CPU over gloo.

Ranks are spawned processes (`tests/torch_shard_ranks.py`, one torch
thread each, a file store under the test's tmp dir), two worlds of W = 2
and W = 4 ranks, each started once for the module; the dense runs and the
reference run in this process.  The contract, as in the reference's
tests/test_client_sharding.py: with `clients_shards = W` each rank holds
N_pad / W client rows, selection runs on the gathered (N,) state, and
selections, params, the test and validation curves, `sv_final` and
`selection_counts` are BITWISE the port's dense scan (gathers copy bits;
the cross-shard gather sums disjoint int32 words).  Against the
reference's dense scan, on the reference's draws, floats agree at 1e-4
(`test_torch_scan.py`'s bound) and selections exactly.  The config is the
reference test's (N = 13, M = 4, T = 8, stragglers 0.3, privacy 0.05) with
a 784-16-10 MLP and 8 Shapley walks, to keep the file near a minute.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_shard_ranks as ranks
from repro.federated.client import ClientConfig as JaxClientConfig
from repro.federated.server import FLConfig as JaxFLConfig
from repro.federated.server import run_federated as jax_run_federated
from repro.kernels.cohort_gather import cohort_take as jax_cohort_take
from repro.models.mlp_cnn import make_mlp as jax_make_mlp
from repro_torch.engine import graph_flow, make_scan_spec
from repro_torch.engine.round_engine import round_plan
from repro_torch.faults import FaultSpec
from repro_torch.federated.server import run_federated, setup_run
from repro_torch.grid import GridSpec, run_grid
from repro_torch.grid.shard import (
    client_block, clients_padded, pad_batch_clients,
)
from repro_torch.kernels.cohort_gather import cohort_gather
from repro_torch.kernels.cohort_gather.kernel import shard_layout
from repro_torch.kernels.cohort_gather.ref import cohort_gather_shard_ref
from repro_torch.launch import mesh
from repro_torch.launch.compat import Count
from repro_torch.launch.roofline import kernel_cost
from repro_torch.tree import tree_leaves
from test_torch_server import JaxReplayDraws

SOLO = {
    "greedyfed-s0": {}, "greedyfed-s1": {"seed": 1},
    "poc-s0": {"selector": "power_of_choice"},
    "poc-s1": {"selector": "power_of_choice", "seed": 1},
    "faults": {"faults": FaultSpec(), "quarantine": True},
    "serial": {"shapley_impl": "serial", "shapley_max_iters": 4},
}
SEGMENTED = "greedyfed-s0-seg4"     # W = 2 only: 2 segments of 4 rounds
REPLAY = {"seed": 0}                # W = 2 only: the reference's draws


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _replay_draws(over):
    """The reference's key-tree draws of `over`'s run, made here (the
    ranks import no JAX): the initial params and every round's draws."""
    cfg = ranks.base_cfg(**over)
    draws = JaxReplayDraws(cfg.seed, jax_make_mlp(784, (16,), 10),
                           cfg.rounds, cfg.m)
    s = setup_run(cfg, model=ranks.model(), device="cpu", draws=draws)
    spec = make_scan_spec(cfg, (s.sel_spec,))
    plan = round_plan(spec.round, cfg.client, spec.selectors, cfg.n_clients,
                      cfg.m, s.params, s.valid_counts)
    return (draws.init_params(None),
            [draws.round(t, plan) for t in range(cfg.rounds)])


def _jobs(world):
    jobs = [("take", "take", {}), ("state", "state", {}),
            ("too_few", "too_few", {})]
    jobs += [(k, "solo", {"over": v}) for k, v in SOLO.items()]
    if world == 2:
        jobs.append((SEGMENTED, "solo", {"over": {}, "segments": 4}))
        jobs.append(("telemetry", "telemetry", {}))
        init, rounds = _replay_draws(REPLAY)
        jobs.append(("replay", "replay", {"over": REPLAY, "init": init,
                                          "rounds": rounds}))
    return jobs


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """{W: [rank 0's results, ...]} for W = 2 and 4; the W = 4 world also
    runs the 2 x 2 grid."""
    out = {}
    for world in (2, 4):
        tmp = tmp_path_factory.mktemp(f"world{world}")
        jobs = _jobs(world)
        if world == 4:
            ckpt = tmp_path_factory.mktemp("ckpt4")
            jobs.append(("grid", "grid", {"ckpt": str(ckpt)}))
        out[world] = ranks.spawn(world, tmp, jobs)
    return out


@pytest.fixture(scope="module")
def dense():
    """The port's dense scan of every solo case, here."""
    return {k: run_federated(ranks.base_cfg(**v), model=ranks.model(),
                             device="cpu") for k, v in SOLO.items()}


def _ok(result):
    if isinstance(result, dict) and "error" in result:
        pytest.fail(result["error"])
    return result


def _assert_bitwise(got, want):
    assert len(got.selections) == len(want.selections)
    for a, b in zip(got.selections, want.selections):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tree_leaves(got.params), tree_leaves(want.params)):
        assert torch.equal(a, b)
    assert got.test_acc == want.test_acc and got.val_loss == want.val_loss
    np.testing.assert_array_equal(got.sv_final.view(np.uint32),
                                  want.sv_final.view(np.uint32))
    np.testing.assert_array_equal(got.selection_counts,
                                  want.selection_counts)
    assert got.upload_bytes == want.upload_bytes
    assert got.quarantined_total == want.quarantined_total
    assert got.shapley_evals == want.shapley_evals


def _bytes(x) -> bytes:
    if isinstance(x, torch.Tensor):
        return x.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(np.asarray(x)).tobytes()


def _to_jax(t: torch.Tensor):
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.view(torch.int16).numpy()).view(jnp.bfloat16)
    if t.dtype == torch.int64:       # the reference runs without x64
        return jnp.asarray(t.numpy().astype(np.int32))
    return jnp.asarray(t.numpy())


# ---------------------------------------------------------- the gather ----

@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", sorted(ranks.take_tables()))
def test_cross_shard_take_bitwise(worlds, world, name):
    """Each rank's sharded gather of its block equals the dense gather, the
    port's and the reference's, bit for bit: -0.0, the NaN payload and inf
    survive, int64, bool and bf16 rows of 6 and 8 bytes included."""
    table = ranks.take_tables()[name]
    ids = torch.tensor(ranks.TAKE_IDS)
    want = cohort_gather(table, ids)
    ref = np.asarray(jax_cohort_take(_to_jax(table), jnp.asarray(ids)))
    if table.dtype == torch.int64:
        ref = ref.astype(np.int64)
    assert _bytes(want) == _bytes(ref)
    for r, res in enumerate(worlds[world]):
        got = _ok(res["take"])[name]
        assert got.dtype == table.dtype and got.shape == want.shape
        assert _bytes(got) == _bytes(want), (world, r)


@pytest.mark.parametrize("world", [2, 4])
def test_cross_shard_take_of_a_tree_is_one_collective(worlds, world):
    """Four leaves of four dtypes in one call: one all_reduce, every leaf
    bitwise; an id of N raises IndexError on every rank."""
    tables = ranks.take_tables()
    ids = torch.tensor(ranks.TAKE_IDS)
    for res in worlds[world]:
        got = _ok(res["take"])
        assert got["tree_collectives"] == {"all_gather": 0, "all_reduce": 1}
        for name, leaf in got["tree"].items():
            assert _bytes(leaf) == _bytes(cohort_gather(tables[name], ids))
        assert "cohort ids must index [0, 16)" in got["bad_id"]


@pytest.mark.parametrize("n,shards", [(16, 8), (13, 8), (50, 8)])
def test_plain_blocks_sum_to_the_dense_gather(n, shards):
    """The sharded entry's plain version, one process: the W = 8 blocks'
    packed words summed as int32 equal the dense gather's bytes in the
    packed layout, pad bytes zero."""
    tables = {k: torch.cat([v] * 4)[:n]
              for k, v in ranks.take_tables().items()}
    n_pad = clients_padded(n, shards)
    ids = torch.tensor([0, n - 1, n // 2, 3, n - 1])
    total = None
    for b in range(shards):
        lo, hi = client_block(n, shards, b)
        block = [torch.cat([v, v.new_zeros((n_pad - n,) + v.shape[1:])])
                 [lo:hi] for v in tables.values()]
        words = cohort_gather_shard_ref(block, ids, lo, n)
        total = words if total is None else total + words
    row_bytes = [v[0].numel() * v.element_size() for v in tables.values()]
    offsets, size = shard_layout(row_bytes, len(ids))
    assert total.numel() * 4 == size and all(o % 16 == 0 for o in offsets)
    want = torch.zeros((size,), dtype=torch.uint8)
    for v, off, rb in zip(tables.values(), offsets, row_bytes):
        want[off:off + len(ids) * rb] = cohort_gather(v, ids).contiguous() \
            .reshape(-1).view(torch.uint8)
    assert torch.equal(total.view(torch.uint8), want)
    with pytest.raises(IndexError):
        cohort_gather_shard_ref(block, torch.tensor([n]), 0, n)


def test_sharded_gather_formula_and_meta_route():
    """The sharded entry counts its formula (`kernel_cost`: the block's
    hits read, M rows written, the ids and the error word) on the meta
    route, with no collective."""
    flops, nbytes, _ = kernel_cost("cohort_gather_shard", m=5,
                                   row_bytes=100, hits=2)
    assert flops == 0 and nbytes == (2 + 5) * 100 + 5 * 8 + 8
    meta = torch.empty((7, 25), device="meta")
    ids = torch.tensor([0, 3])
    with Count() as c:
        out = cohort_gather(meta, ids, axis_name=mesh.CLIENT_AXIS,
                            n_clients=7)
    assert out.shape == (2, 25) and out.device.type == "meta"
    assert c.bytes == kernel_cost("cohort_gather_shard", m=2,
                                  row_bytes=100)[1]
    assert c.by_kernel["cohort_gather_shard"]["calls"] == 1


# -------------------------------------------------------- selector state --

def _state_leaves(st):
    return [*st.valuation, st.round, st.rr_order, st.active, st.frozen]


@pytest.mark.parametrize("world", [2, 4])
def test_gather_client_state_round_trips(worlds, world):
    """gather_client_state gives the exact (N,) state on every rank, the
    losses beside it; put_back of an updated state gives each rank's block
    of the update, the pad rows unchanged, bitwise."""
    for res in worlds[world]:
        got = _ok(res["state"])
        full, lo, hi = got["full"], got["lo"], got["hi"]
        for a, b in zip(_state_leaves(got["got"]), _state_leaves(full)):
            want = b if b.dim() == 0 else b[:ranks.N]
            assert _bytes(a) == _bytes(want)
        assert _bytes(got["got_losses"]) == _bytes(got["losses"][:ranks.N])
        back = got["back"]
        sv = torch.cat([full.valuation.sv[:ranks.N] + 1.0,
                        full.valuation.sv[ranks.N:]])
        assert _bytes(back.valuation.sv) == _bytes(sv[lo:hi])
        for a, b in ((back.valuation.counts, full.valuation.counts),
                     (back.valuation.initialised,
                      full.valuation.initialised),
                     (back.rr_order, full.rr_order),
                     (back.active, full.active)):
            assert _bytes(a) == _bytes(b[lo:hi])
        assert int(back.round) == 4 and bool(back.frozen)


# ---------------------------------------------------------------- runs ----

@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case", sorted(SOLO))
def test_sharded_run_is_bitwise_the_dense_scan(worlds, dense, world, case):
    """run_federated(clients_shards=W) on every rank: bitwise the dense
    scan; each rank's step held N_pad / W rows of every per-client
    operand."""
    n_local = clients_padded(ranks.N, world) // world
    for res in worlds[world]:
        got = _ok(res[case])
        _assert_bitwise(got["result"], dense[case])
        assert got["rows"] == [(n_local,) * 6]


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case", ["greedyfed-s0", "poc-s0", "serial"])
def test_a_sharded_round_makes_two_collectives(worlds, world, case):
    """Per round one all_gather (the selector state, the Power-of-Choice
    losses in the same buffer) and one all_reduce (the cohort); one more
    all_gather after the run (the final state); none inside a conditional
    node (the serial estimator's, which would raise)."""
    for res in worlds[world]:
        assert _ok(res[case])["collectives"] == {
            "all_gather": ranks.T + 1, "all_reduce": ranks.T}


def test_segmented_sharded_run_is_the_whole_run(worlds, dense):
    for res in worlds[2]:
        got = _ok(res[SEGMENTED])
        _assert_bitwise(got["result"], dense["greedyfed-s0"])
        assert got["collectives"] == {"all_gather": ranks.T + 1,
                                      "all_reduce": ranks.T}


def test_collectives_refuse_a_conditional_body():
    flag = torch.tensor(True)

    def body():
        mesh.all_reduce_words(torch.zeros((1,), dtype=torch.int32), None)

    with pytest.raises(RuntimeError, match="conditional"):
        graph_flow.if_(flag, body, [])


def test_sharded_run_on_reference_draws_matches_the_reference(worlds):
    """A W = 2 sharded run on the reference's key-tree draws against the
    reference's dense engine="scan": selections, bytes and counts equal,
    floats at 1e-4."""
    cfg = ranks.base_cfg(**REPLAY)
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
          if f.name not in ("client", "selector_kwargs", "faults",
                            "schedule", "clients_shards")}
    want = jax_run_federated(
        JaxFLConfig(client=JaxClientConfig(
            epochs=1, batch_size=8, lr=0.05), **kw),
        model=jax_make_mlp(784, (16,), 10))
    for res in worlds[2]:
        got = _ok(res["replay"])
        for a, b in zip(got.selections, want.selections):
            np.testing.assert_array_equal(a, np.asarray(b))
        assert got.upload_bytes == want.upload_bytes
        np.testing.assert_array_equal(got.selection_counts,
                                      np.asarray(want.selection_counts))
        np.testing.assert_allclose([a for _, a in got.test_acc],
                                   [a for _, a in want.test_acc], atol=1e-4)
        np.testing.assert_allclose([v for _, v in got.val_loss],
                                   [v for _, v in want.val_loss], atol=1e-4)
        np.testing.assert_allclose(got.sv_final, np.asarray(want.sv_final),
                                   atol=1e-4)
        for a, b in zip(tree_leaves(got.params),
                        jax.tree.leaves(want.params)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)


def test_only_rank_0_streams_the_dense_runs_events(worlds):
    """With a sink on every rank, rank 0 emits the dense run's stream (the
    same events in order, the same round and eval records) but for the
    compile event's program, "run_scan_client_sharded"; rank 1 emits
    nothing."""
    from repro_torch.telemetry import Telemetry
    tel = Telemetry()
    run_federated(ranks.base_cfg(), model=ranks.model(), device="cpu",
                  telemetry=tel)
    got = _ok(worlds[2][0]["telemetry"])
    assert _ok(worlds[2][1]["telemetry"]) == []
    assert [e["event"] for e in got] == [e["event"] for e in tel.events]
    compile_ = [e for e in got if e["event"] == "compile"]
    assert [e["program"] for e in compile_] == ["run_scan_client_sharded"]
    for a, b in zip(got, tel.events):
        if a["event"] in ("round_metrics", "eval"):
            assert {k: v for k, v in a.items() if k != "t_s"} == \
                {k: v for k, v in b.items() if k != "t_s"}


@pytest.mark.parametrize("world", [2, 4])
def test_too_few_ranks_raise(worlds, world):
    for res in worlds[world]:
        assert res["too_few"] == (
            f"clients_shards={2 * world} needs that many ranks but only "
            f"{world} are available (launch with torchrun --nproc-per-node "
            f"{2 * world}, or init_process_group with that world size)")
    with pytest.raises(ValueError, match="needs that many ranks but only 1"):
        run_federated(ranks.base_cfg(clients_shards=2), model=ranks.model(),
                      device="cpu")


# ---------------------------------------------------------------- grid ----

def test_grid_on_a_2x2_mesh_is_bitwise_and_resumes(worlds):
    """greedyfed and power_of_choice x seeds (0, 1) on a 2 x 2 (replicas x
    clients) mesh of 4 ranks: every cell bitwise the dense grid on every
    rank; killed after one segment and resumed, bitwise again with fewer
    dispatches; each rank kept its own checkpoint files."""
    spec = GridSpec.product(ranks.base_cfg(),
                            selectors=["greedyfed", "power_of_choice"],
                            seeds=(0, 1))
    want = run_grid(spec, model=ranks.model(), device="cpu",
                    rounds_per_segment=4)
    for res in worlds[4]:
        got = _ok(res["grid"])
        assert got["partial"] is None
        for grid in (got["whole"], got["resumed"]):
            for a, b in zip(grid.results, want.results):
                _assert_bitwise(a, b)
        assert got["resumed"].dispatches < got["whole"].dispatches
        assert [p.cell_indices for p in got["whole"].partitions] == \
            [p.cell_indices for p in want.partitions]
        tags = {f.split("seg")[0] for f in got["files"]
                if f.endswith(".npz")}
        assert tags == {f"p{p}-r{r}c{c}-" for p in (0, 1) for r in (0, 1)
                        for c in (0, 1)}


def test_pad_batch_clients_cuts_every_client_operand():
    """A replica batch cut to block 1 of 4 (N = 13, N_pad = 16): the stacks,
    sigma, both tables and the selector state hold rows [4, 8)."""
    from repro_torch.engine.round_engine import SegmentCarry
    from repro_torch.engine.scan_engine import scan_operands
    from repro_torch.grid.segments import ReplicaBatch
    cfg = ranks.base_cfg()
    s = setup_run(cfg, model=ranks.model(), device="cpu")
    ops = scan_operands(cfg, s)
    batch = ReplicaBatch(cfgs=(cfg,), setups=(s,), ops=(ops,), plans=(None,),
                         carries=(SegmentCarry(s.params, s.sel_state,
                                               torch.zeros(())),))
    cut = pad_batch_clients(batch, 4, 1)
    o = cut.ops[0]
    assert torch.equal(o.xs_all, ops.xs_all[4:8])
    assert torch.equal(o.nv_all, ops.nv_all[4:8])
    assert torch.equal(o.epochs_table, ops.epochs_table[:, 4:8])
    assert torch.equal(o.sigma_all, ops.sigma_all[4:8])
    assert torch.equal(cut.carries[0].sel_state.rr_order,
                       s.sel_state.rr_order[4:8])
    last = pad_batch_clients(batch, 4, 3).ops[0]    # rows 12..15: 3 pads
    assert torch.equal(last.nv_all[1:], torch.zeros(3, dtype=torch.int64))
    assert torch.equal(o.fractions, ops.fractions)
    sh = setup_run(cfg, model=ranks.model(), device="cpu", shard=(1, 4))
    assert torch.equal(sh.xs, ops.xs_all[4:8]) and sh.xs.shape[0] == 4
