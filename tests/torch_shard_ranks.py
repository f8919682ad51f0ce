"""Rank bodies of the client-sharding tests
(tests/test_torch_client_sharding.py).

Spawned processes import this module (not the test file, which imports
JAX): each joins a gloo world through a file store, runs the jobs it is
given and saves what they return to `out/rank{r}.pt`.  Everything here is
the port's, on the CPU, one torch thread a rank.
"""
from __future__ import annotations

import os
import traceback

import numpy as np
import torch

N, M, T = 13, 4, 8


def base_cfg(**over):
    """The reference sharding test's config (N = 13, M = 4, T = 8,
    stragglers 0.3, privacy 0.05), with GTG-Shapley cut to 8 walks."""
    from repro_torch.federated.client import ClientConfig
    from repro_torch.federated.server import FLConfig
    kw = dict(n_clients=N, m=M, rounds=T, selector="greedyfed",
              engine="scan", eval_every=4, n_train=400, n_val=60, n_test=60,
              straggler_frac=0.3, privacy_sigma=0.05, shapley_max_iters=8,
              client=ClientConfig(epochs=1, batch_size=8, lr=0.05))
    return FLConfig(**{**kw, **over})


def model():
    from repro_torch.models.mlp_cnn import make_mlp
    return make_mlp(784, (16,), 10)


def take_tables(n: int = 16) -> dict:
    """The cross-shard take's tables, from a numpy seed: f32 holding -0.0,
    a NaN payload and inf; int64; bool; bf16 of odd and even widths."""
    rng = np.random.default_rng(0)
    f32 = rng.standard_normal((n, 33)).astype(np.float32)
    f32.view(np.int32)[0, 0] = -(2 ** 31)                 # -0.0
    f32.view(np.int32)[1, 1] = 0x7fc01234                 # NaN payload
    f32[n - 1, 2] = np.inf
    bf = rng.standard_normal((n, 5)).astype(np.float32)
    return {
        "f32": torch.from_numpy(f32),
        # int32's range: the reference runs without x64
        "i64": torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (n, 3))),
        "bool": torch.from_numpy(rng.random((n, 3)) < 0.5),
        "bf16_odd": torch.from_numpy(bf[:, :3]).to(torch.bfloat16),
        "bf16_even": torch.from_numpy(bf[:, :4]).to(torch.bfloat16),
        "f32_vec": torch.from_numpy(f32[:, 0].copy()),
    }


TAKE_IDS = [0, 1, 7, 15, 1, 9]


class FixedDraws:
    """A `RunDraws` of draws made beforehand, round by round (the test
    makes them from the reference's key tree, `JaxReplayDraws`)."""

    def __init__(self, init, rounds):
        self._init, self._rounds = init, rounds

    def init_params(self, model):
        return {k: {n: t.clone() for n, t in v.items()}
                for k, v in self._init.items()}

    def round(self, t, plan):
        return self._rounds[t]

    def state(self):
        return torch.zeros((1,), dtype=torch.uint8)

    def set_state(self, state):
        pass


# ------------------------------------------------------------------ jobs --

def _cloned(x):
    """Tensors cloned through dicts and (named) tuples: a gather's outputs
    are views of one buffer, which torch.save refuses as mixed types."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, dict):
        return {k: _cloned(v) for k, v in x.items()}
    if isinstance(x, tuple):
        parts = [_cloned(v) for v in x]
        return type(x)(*parts) if hasattr(x, "_fields") else tuple(parts)
    return x


def job_take(rank, world, group):
    """Every table's block through the sharded gather: each alone, and
    four in one call (one collective)."""
    from repro_torch.grid.shard import client_block
    from repro_torch.kernels.cohort_gather import cohort_gather
    from repro_torch.launch import mesh
    tables = take_tables()
    n = next(iter(tables.values())).shape[0]
    lo, hi = client_block(n, world, rank)
    blocks = {k: v[lo:hi] for k, v in tables.items()}
    ids = torch.tensor(TAKE_IDS)
    out = {k: cohort_gather(v, ids, axis_name=group, n_clients=n)
           for k, v in blocks.items()}
    mesh.reset_collectives()
    four = {k: blocks[k] for k in ("f32", "i64", "bool", "bf16_odd")}
    out["tree"] = cohort_gather(four, ids, axis_name=group, n_clients=n)
    out["tree_collectives"] = dict(mesh.COLLECTIVES)
    try:
        cohort_gather(blocks["f32"], torch.tensor([0, n]), axis_name=group,
                      n_clients=n)
        out["bad_id"] = "no error"
    except IndexError as e:
        out["bad_id"] = str(e)
    return _cloned(out)


def job_state(rank, world, group):
    """gather_client_state then put_back of an updated state: the blocks
    and their pad rows back bitwise."""
    from repro_torch.core.selection import (
        DeviceSelectorState, gather_client_state,
    )
    from repro_torch.core.valuation import ValuationState
    from repro_torch.grid.shard import client_block, clients_padded
    n_pad = clients_padded(N, world)
    lo, hi = client_block(N, world, rank)
    g = torch.Generator().manual_seed(5)
    full = DeviceSelectorState(
        valuation=ValuationState(
            sv=torch.randn((n_pad,), generator=g),
            counts=torch.randint(0, 9, (n_pad,), generator=g,
                                 dtype=torch.int32),
            initialised=torch.rand((n_pad,), generator=g) < 0.5),
        round=torch.tensor(3), rr_order=torch.randperm(n_pad, generator=g),
        active=torch.rand((n_pad,), generator=g) < 0.5,
        frozen=torch.tensor(True))
    block = full._replace(
        valuation=ValuationState(*(x[lo:hi] for x in full.valuation)),
        rr_order=full.rr_order[lo:hi], active=full.active[lo:hi])
    losses = torch.randn((n_pad,), generator=g)
    got, put_back, (got_losses,) = gather_client_state(
        block, group, N, (losses[lo:hi],))
    new = got._replace(valuation=got.valuation._replace(
        sv=got.valuation.sv + 1.0), round=got.round + 1)
    back = put_back(new)
    return _cloned({"full": full, "losses": losses, "got": got,
                    "got_losses": got_losses, "back": back, "lo": lo,
                    "hi": hi})


_BLOCK_ROWS: list = []


def _record_blocks():
    """Record the client rows of every step the sharded path builds."""
    from repro_torch.grid import shard
    base = shard.SegmentStep

    class Recording(base):
        def __init__(self, model, ccfg, spec, ops_list, **kw):
            _BLOCK_ROWS.extend(
                (o.xs_all.shape[0], o.ys_all.shape[0], o.nv_all.shape[0],
                 o.sigma_all.shape[0], o.epochs_table.shape[1],
                 o.fault_table.shape[1]) for o in ops_list)
            super().__init__(model, ccfg, spec, ops_list, **kw)

    shard.SegmentStep = Recording


def job_solo(rank, world, group, over, segments=0):
    """run_federated(clients_shards=world) of `over`, with the collectives
    it made and the client rows of its step's operands."""
    from repro_torch.federated.server import run_federated
    from repro_torch.launch import mesh
    _BLOCK_ROWS.clear()
    mesh.reset_collectives()
    res = run_federated(base_cfg(clients_shards=world, **over),
                        model=model(), device="cpu",
                        rounds_per_segment=segments)
    return {"result": res, "collectives": dict(mesh.COLLECTIVES),
            "rows": list(_BLOCK_ROWS)}


def job_replay(rank, world, group, over, init, rounds):
    """A sharded run on draws made beforehand (the reference's)."""
    from repro_torch.federated.server import run_federated
    return run_federated(base_cfg(clients_shards=world, **over),
                         model=model(), device="cpu",
                         draws=FixedDraws(init, rounds))


def job_grid(rank, world, group, ckpt):
    """The 2 x 2 grid: whole, then killed after one segment and resumed."""
    from repro_torch.grid import GridSpec, run_grid
    spec = GridSpec.product(base_cfg(clients_shards=2),
                            selectors=["greedyfed", "power_of_choice"],
                            seeds=(0, 1))
    whole = run_grid(spec, model=model(), device="cpu",
                     rounds_per_segment=4)
    partial = run_grid(spec, model=model(), device="cpu",
                       rounds_per_segment=4, checkpoint_dir=ckpt,
                       max_segments=1)
    resumed = run_grid(spec, model=model(), device="cpu",
                       rounds_per_segment=4, checkpoint_dir=ckpt)
    return {"whole": whole, "partial": partial, "resumed": resumed,
            "files": sorted(os.listdir(ckpt))}


def job_telemetry(rank, world, group):
    """A sharded run with an in-memory sink on every rank: the events each
    rank's sink received."""
    from repro_torch.federated.server import run_federated
    from repro_torch.telemetry import Telemetry
    tel = Telemetry()
    run_federated(base_cfg(clients_shards=world), model=model(),
                  device="cpu", telemetry=tel)
    return tel.events


def job_too_few(rank, world, group):
    from repro_torch.federated.server import run_federated
    try:
        run_federated(base_cfg(clients_shards=2 * world), model=model(),
                      device="cpu")
    except ValueError as e:
        return str(e)
    return "no error"


JOBS = {"take": job_take, "state": job_state, "solo": job_solo,
        "replay": job_replay, "grid": job_grid, "too_few": job_too_few,
        "telemetry": job_telemetry}


def main(rank: int, world: int, store: str, out: str, jobs: list) -> None:
    """One rank: join the gloo world, run `jobs` ((key, name, kwargs)),
    save {key: result or the traceback of its error}."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import client_mesh
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    _record_blocks()
    group = client_mesh(1, world).get_group("clients")
    results = {}
    for key, name, kwargs in jobs:
        try:
            results[key] = JOBS[name](rank, world, group, **kwargs)
        except Exception:
            results[key] = {"error": traceback.format_exc()}
    torch.save(results, os.path.join(out, f"rank{rank}.pt"))
    dist.destroy_process_group()


def spawn(world: int, tmp, jobs: list) -> list:
    """Run `jobs` on `world` spawned ranks; each rank's results."""
    import torch.multiprocessing as mp
    store = os.path.join(tmp, "store")
    mp.start_processes(main, args=(world, store, str(tmp), jobs),
                       nprocs=world, start_method="spawn")
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]

