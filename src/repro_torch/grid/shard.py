"""Sharded replicas and sharded clients: runs on a (replicas, clients)
mesh of ranks (counterpart of `repro/grid/shard.py`, over
`torch.distributed` in place of `shard_map`).

The program is SPMD: every rank calls the same entry point and holds a
part of the work (`launch/mesh.py`).

  * `REPLICA_AXIS`: a grid partition's replicas split over the mesh's
    rows, whole replicas a rank.  Replicas never communicate, so a rank's
    replicas are an ordinary `SegmentStep` of its own (`grid/runner.py`).
  * `CLIENT_AXIS`: the client population.  Every per-client tensor of a
    run (the padded data stacks, n_valid, sigma, the (T, N) epoch and
    fault tables, the per-client selector state) is padded to N_pad, a
    multiple of the shard count, and each rank of a row holds one block
    of N_pad / shards rows: client memory O(N / shards) a rank.  Selection
    is a global top-m and the cohort comes from every block, so a round
    makes two collectives over the row's clients group
    (`engine/round_engine.py::_make_scan_body`); a sharded run is bitwise
    the dense one.

`sharded_segment_step` builds the segment step of a rank's replicas with
the clients group in the spec; `pad_batch_clients` cuts a replica batch
to the rank's block; `unpad_scan_output` gathers a run's final selector
state back to its exact (N,) form, the dense run's shapes.  The pad rows
[N, N_pad) are zero clients that nothing reads: selection runs on the
gathered state sliced to N, the gather only meets real ids, and
`put_back` keeps the pad rows of the state at their initial zeros.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.selection import gather_client_state
from repro_torch.engine.round_engine import ScanSpec, SegmentStep
from repro_torch.launch.mesh import (  # re-export
    CLIENT_AXIS, REPLICA_AXIS, client_mesh, make_replica_mesh, make_run_mesh,
    position, world,
)

__all__ = ["CLIENT_AXIS", "REPLICA_AXIS", "client_block", "client_mesh",
           "clients_padded", "make_replica_mesh", "make_run_mesh",
           "pad_batch_clients", "position", "sharded_segment_step",
           "share_result", "share_results", "unpad_scan_output"]


def clients_padded(n_clients: int, shards: int) -> int:
    """Smallest multiple of `shards` >= n_clients."""
    return -(-n_clients // shards) * shards


def client_block(n_clients: int, shards: int, index: int) -> tuple[int, int]:
    """Rows [lo, hi) of block `index` of the padded (N_pad,) client axis."""
    n_local = clients_padded(n_clients, shards) // shards
    return index * n_local, (index + 1) * n_local


def _client_axis_of(mesh):
    """The clients group of this rank in `mesh`, None for a replica mesh."""
    names = mesh.mesh_dim_names or ()
    return mesh.get_group(CLIENT_AXIS) if CLIENT_AXIS in names else None


def sharded_segment_step(model, ccfg, spec: ScanSpec, ops_list: list, mesh,
                         **options) -> SegmentStep:
    """The segment step of this rank's replicas on `mesh`: with a clients
    axis (of any size, one rank included) the round is the client-sharded
    one, its spec naming this rank's clients group, and `ops_list` holds
    the rank's blocks (`pad_batch_clients`); on a replica mesh it is the
    plain step of the rank's whole replicas."""
    group = _client_axis_of(mesh)
    if group is not None:
        spec = spec._replace(round=spec.round._replace(client_axis=group))
    return SegmentStep(model, ccfg, spec, list(ops_list), **options)


def _block(x, n_clients: int, lo: int, hi: int, axis: int = 0):
    """Rows [lo, hi) of the zero-padded client axis `axis` of `x` (a
    tensor); a tensor that already holds hi - lo rows is the block."""
    size = x.shape[axis]
    if size == hi - lo and size != n_clients:
        return x
    if size != n_clients:
        raise ValueError(f"a client axis of {size} rows, neither N = "
                         f"{n_clients} nor a block of {hi - lo}")
    pad = max(hi - size, 0)
    if pad:
        shape = list(x.shape)
        shape[axis] = pad
        x = torch.cat([x, x.new_zeros(shape)], dim=axis)
    return x.narrow(axis, lo, hi - lo).contiguous()


def pad_batch_clients(batch, shards: int, index: int):
    """The ReplicaBatch of this rank's client block `index` of `shards`:
    every client-axis operand of each replica zero-padded to N_pad and cut
    to rows [lo, lo + N_pad / shards): the data stacks, n_valid and sigma
    (axis 0; stacks that `setup_run(..., shard=)` built as the block stay),
    the epoch and fault tables (axis 1) and the per-client selector state
    of the carries.  Fractions, params and the scalars stay whole."""
    n = batch.cfgs[0].n_clients
    lo, hi = client_block(n, shards, index)
    ops = tuple(o._replace(
        xs_all=_block(o.xs_all, n, lo, hi),
        ys_all=_block(o.ys_all, n, lo, hi),
        nv_all=_block(o.nv_all, n, lo, hi),
        sigma_all=_block(o.sigma_all, n, lo, hi),
        epochs_table=_block(o.epochs_table, n, lo, hi, axis=1),
        fault_table=_block(o.fault_table, n, lo, hi, axis=1))
        for o in batch.ops)

    def state_block(state):
        val = state.valuation
        return state._replace(
            valuation=val._replace(
                sv=_block(val.sv, n, lo, hi),
                counts=_block(val.counts, n, lo, hi),
                initialised=_block(val.initialised, n, lo, hi)),
            rr_order=_block(state.rr_order, n, lo, hi),
            active=_block(state.active, n, lo, hi))

    carries = tuple(c._replace(sel_state=state_block(c.sel_state))
                    for c in batch.carries)
    return batch._replace(ops=ops, carries=carries)


def unpad_scan_output(out: dict, n_clients: int, axis) -> dict:
    """A client-sharded run's result dict (`run_segments`' form) in the
    dense run's shapes: the final carry's selector state all-gathered over
    the clients group `axis` and cut to its exact (N,) vectors, and
    `sv_final` / `counts` read from it.  One collective, after the run."""
    full, _, _ = gather_client_state(out["carry"].sel_state, axis, n_clients)
    carry = out["carry"]._replace(sel_state=full)
    return {**out, "carry": carry,
            "sv_final": full.valuation.sv.cpu().numpy(),
            "counts": full.valuation.counts.cpu().numpy()}


def _to(tree, device):
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_to(v, device) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, device) for v in tree)
    return tree


def share_results(local: dict, device) -> dict:
    """Every rank's {key: result} merged on every rank, through the host
    (`all_gather_object`, outside any round); tensors travel on the CPU
    and land on `device`.  The first rank to hold a key wins (ranks of a
    replica row hold equal results).  A world of one rank returns `local`."""
    import torch.distributed as dist
    if world()[1] <= 1:
        return local
    parts = [None] * world()[1]
    dist.all_gather_object(parts, _to(local, "cpu"))
    merged: dict = {}
    for part in parts:
        for key, value in part.items():
            merged.setdefault(key, value)
    return {k: _to(v, device or "cpu") for k, v in merged.items()}


def share_result(result: Optional[object], device):
    """The result that the ranks holding one (not None) computed, on every
    rank: for a run whose mesh leaves some ranks of the world out."""
    return share_results({} if result is None else {0: result}, device)[0]

