"""Meshes over `torch.distributed` (counterpart of `repro/launch/mesh.py`):
the LMs' (data, model) meshes, and the federated engines' run meshes.

LM meshes (`LMMesh`): named axes over ranks, the first the major one.

  * `make_production_mesh(multi_pod=False)`: (16, 16) over ("data",
    "model"), or (2, 16, 16) over ("pod", "data", "model"), as the
    reference's 256 / 512 chips;
  * `make_debug_mesh(shape=(2, 2), axes=("data", "model"))`;
  * `batch_axes(mesh)`: every axis but "model".

A mesh is live or virtual.  A live mesh spans the world's ranks and
holds one process group a set of its axes (its `DeviceMesh`'s for single
axes, `new_group`s for the sets of several), NCCL on cards and gloo on the
CPU (and for several ranks on one card), as the run meshes below.  A virtual mesh has the sizes and this rank's
coordinates (rank 0's by default) and no group: the collectives over it
count and return shapes only (`launch/collectives.py`), which is how the
dry-run counts a 256- or 512-device step on `meta` tensors in one
process.  `make_production_mesh` returns the virtual form when the world
is smaller than the mesh (the reference raises there: JAX forces 512 host
devices, torch has nothing like it).  The model reads the ambient mesh
that `compat.set_mesh` installs.

Run meshes of the federated engines (the run half of the reference's):

The program is SPMD: a user launches W processes (`torchrun
--nproc-per-node W ...`) and each calls the same entry point
(`run_federated`, `run_grid`).  A mesh is a `DeviceMesh` over those ranks:

  * `make_replica_mesh`: 1-D ("replicas",).  A grid partition's replicas
    split over the ranks, whole replicas a rank; replicas never talk.
  * `make_run_mesh`: 2-D ("replicas", "clients").  Besides, each rank of a
    replica row holds one block of N_pad / clients_shards clients of every
    per-client tensor (data stacks, n_valid, sigma, the epoch and fault
    tables, the selector state), so its client memory is O(N / shards).
    A round makes two collectives over the row's "clients" group: the
    selector state all-gathered to its exact (N,) form, and the cohort's
    rows summed out of the blocks (`kernels/cohort_gather`).

Both take the largest divisor of the replica count that fits the ranks
left, as the reference does; a rank outside the mesh runs nothing of it.
NCCL is the backend on cards, gloo on the CPU.  A world that torchrun
launched is joined here at the first mesh (`init_world`); a caller may
also call `torch.distributed.init_process_group` itself, as the tests do
(gloo, a file store) and `chip_smoke.py` (NCCL, one rank).  Without a
process group the world is one rank and `clients_shards > 1` raises.

The two collectives of a round go through `all_gather_words` and
`all_reduce_words`: int32 words, the one type both backends reduce and
gather (gloo refuses int16, NCCL has no bitwise OR), counted in
`COLLECTIVES`, and never inside a conditional node of a captured round.
"""
from __future__ import annotations

import itertools
import math
import os
from typing import Optional, Sequence

import torch

MODEL_AXIS = "model"
REPLICA_AXIS = "replicas"
CLIENT_AXIS = "clients"

# bytes each packed tensor is padded to (`pack_words`)
ALIGN = 16

# collectives issued, by kind; nothing else touches them
COLLECTIVES = {"all_gather": 0, "all_reduce": 0}

_meshes: dict = {}
_current = None          # the last client mesh made: CLIENT_AXIS resolves here


def reset_collectives() -> None:
    for name in COLLECTIVES:
        COLLECTIVES[name] = 0


def init_world() -> None:
    """Join the world that torchrun launched (its env:// variables), once:
    NCCL when this rank has a card, gloo otherwise.  On cards the kernel
    library is built once a host, by local rank 0, while the other ranks
    wait (concurrent builds would be safe, the library is renamed into
    place whole, but each would run nvcc).  A no-op when a process group
    exists or the environment names no world of more than one rank."""
    import torch.distributed as dist
    if dist.is_initialized() or int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return
    cuda = torch.cuda.is_available()
    if cuda:
        torch.cuda.set_device(rank_device())
    dist.init_process_group("nccl" if cuda else "gloo")
    if cuda:
        from repro_torch import kernels
        if int(os.environ.get("LOCAL_RANK", "0")) == 0:
            kernels.build()
        dist.barrier()


def world() -> tuple[int, int]:
    """(rank, world size) of this process; (0, 1) without a process group."""
    import torch.distributed as dist
    if not dist.is_available() or not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def rank_device() -> torch.device:
    """The device of this rank: `cuda:{LOCAL_RANK}` (torchrun's local rank,
    else the rank modulo the cards) on a host with cards, else the CPU."""
    if not torch.cuda.is_available():
        return torch.device("cpu")
    local = os.environ.get("LOCAL_RANK")
    index = (int(local) if local is not None
             else world()[0] % torch.cuda.device_count())
    return torch.device("cuda", index)


def _device_type() -> str:
    import torch.distributed as dist
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _mesh(shape: tuple, names: tuple):
    """The DeviceMesh of `shape` over ranks 0 .. prod(shape) - 1, made once
    a world (its groups are made by every rank of the world, in one
    order)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if _meshes.get("world") is not dist.group.WORLD:
        _meshes.clear()                 # a new world: the old groups died
        _meshes["world"] = dist.group.WORLD
    key = (shape, names)
    if key not in _meshes:
        _meshes[key] = init_device_mesh(_device_type(), shape,
                                        mesh_dim_names=names)
    return _meshes[key]


# ------------------------------------------------------------ LM meshes --

class LMMesh:
    """Named axes of ranks (`shape`: name -> size, `axis_names` in major to
    minor order) and this rank's coordinate on each (`coords`).  Live with
    process groups (`group(axes)`), virtual without."""

    def __init__(self, sizes: Sequence[int], names: Sequence[str],
                 coords: Optional[Sequence[int]] = None, groups=None,
                 device_mesh=None):
        self.axis_names = tuple(names)
        self.sizes = tuple(int(n) for n in sizes)
        self.shape = dict(zip(self.axis_names, self.sizes))
        coords = coords if coords is not None else (0,) * len(self.sizes)
        self.coords = dict(zip(self.axis_names, (int(c) for c in coords)))
        self._groups = groups
        self.device_mesh = device_mesh

    @property
    def live(self) -> bool:
        return self._groups is not None

    @property
    def devices(self) -> int:
        return math.prod(self.sizes)

    def __repr__(self) -> str:
        kind = "live" if self.live else "virtual"
        return f"LMMesh({kind}, {self.shape}, at {self.coords})"

    @staticmethod
    def axes(axes) -> tuple:
        """`axes` (a name, a tuple of names, or None) as a tuple."""
        if axes is None:
            return ()
        return (axes,) if isinstance(axes, str) else tuple(axes)

    def index(self, axes) -> tuple[int, int]:
        """(this rank's index, the count) along `axes` flattened, the first
        axis the major one: the block of a dim sharded over them."""
        i, n = 0, 1
        for a in self.axes(axes):
            i, n = i * self.shape[a] + self.coords[a], n * self.shape[a]
        return i, n

    def size(self, axes) -> int:
        return self.index(axes)[1]

    def group(self, axes):
        """The process group of the ranks that share every coordinate but
        `axes` with this one (live meshes only)."""
        if not self.live:
            raise RuntimeError(f"{self!r} has no process groups")
        key = tuple(a for a in self.axis_names if a in self.axes(axes))
        return self._groups[key]


def _rank_of(coords: Sequence[int], sizes: Sequence[int]) -> int:
    r = 0
    for c, n in zip(coords, sizes):
        r = r * n + c
    return r


def lm_mesh(shape: Sequence[int], axes: Sequence[str]) -> LMMesh:
    """An LM mesh of `shape` over `axes`: live when the world has exactly
    prod(shape) ranks (made once a world; every rank calls this in one
    order), virtual at rank 0's coordinates when it has fewer (one
    process: the dry-run's production meshes).  Raises ValueError when
    the world has more ranks than the mesh."""
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    n = math.prod(shape)
    init_world()
    rank, size = world()
    if size < n or size == 1:
        return LMMesh(shape, axes)
    if size > n:
        raise ValueError(f"a {shape} mesh over a world of {size} ranks: the "
                         f"mesh must span the world")
    import torch.distributed as dist
    device_mesh = _mesh(shape, axes)     # one group an axis
    key = ("lm", shape, axes)
    if key not in _meshes:               # and one a set of several axes
        groups = {(a,): device_mesh.get_group(a) for a in axes}
        for k in range(2, len(axes) + 1):
            for sub in itertools.combinations(range(len(axes)), k):
                others = [i for i in range(len(axes)) if i not in sub]
                for rest in itertools.product(*(range(shape[i])
                                                 for i in others)):
                    ranks = []
                    for inner in itertools.product(*(range(shape[i])
                                                     for i in sub)):
                        c = [0] * len(axes)
                        for i, v in zip(others, rest):
                            c[i] = v
                        for i, v in zip(sub, inner):
                            c[i] = v
                        ranks.append(_rank_of(c, shape))
                    g = dist.new_group(ranks)
                    if rank in ranks:
                        groups[tuple(axes[i] for i in sub)] = g
        _meshes[key] = groups
    coords = device_mesh.get_coordinate()
    return LMMesh(shape, axes, coords, _meshes[key], device_mesh)


def make_production_mesh(*, multi_pod: bool = False) -> LMMesh:
    """(16, 16) over ("data", "model"), or (2, 16, 16) over ("pod",
    "data", "model"): live on a world of that many ranks, else virtual."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return lm_mesh(shape, axes)


def make_debug_mesh(shape=(2, 2), axes=("data", "model")) -> LMMesh:
    """A small mesh for the CPU's gloo tests and one card's ranks."""
    return lm_mesh(shape, axes)


def batch_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in mesh.axis_names if a != MODEL_AXIS)


def _largest_divisor(n: int, limit: int) -> int:
    return max((d for d in range(1, limit + 1) if n % d == 0), default=1)


def make_replica_mesh(n_replicas: int, *, max_devices: Optional[int] = None):
    """1-D mesh over the largest rank count that divides `n_replicas`, so
    every rank holds whole replicas; None when one rank would be used (the
    caller runs the plain path)."""
    init_world()
    size = world()[1]
    limit = min(size, max_devices or size, n_replicas)
    n = _largest_divisor(n_replicas, limit)
    return None if n <= 1 else _mesh((n,), (REPLICA_AXIS,))


def make_run_mesh(n_replicas: int, clients_shards: int = 1, *,
                  max_devices: Optional[int] = None):
    """2-D (replicas, clients) mesh of a run: `clients_shards` ranks a
    replica row, and the largest divisor of `n_replicas` rows that the
    ranks left hold.  With `clients_shards <= 1` it is
    `make_replica_mesh`.  Raises ValueError when the world has fewer than
    `clients_shards` ranks."""
    if clients_shards <= 1:
        return make_replica_mesh(n_replicas, max_devices=max_devices)
    init_world()
    size = world()[1]
    limit = min(size, max_devices or size)
    if clients_shards > limit:
        raise ValueError(
            f"clients_shards={clients_shards} needs that many ranks but only "
            f"{limit} are available (launch with torchrun --nproc-per-node "
            f"{clients_shards}, or init_process_group with that world size)")
    r = _largest_divisor(n_replicas, min(limit // clients_shards, n_replicas))
    return client_mesh(r, clients_shards)


def client_mesh(n_rows: int, clients_shards: int):
    """The (replicas, clients) mesh of exactly that shape, a clients axis
    of one rank included (`make_run_mesh` gives None there): the sharded
    path on a world of one rank, as on one card."""
    global _current
    init_world()
    if n_rows * clients_shards > world()[1]:
        raise ValueError(f"a {n_rows} x {clients_shards} mesh needs "
                         f"{n_rows * clients_shards} ranks but only "
                         f"{world()[1]} are available")
    _current = _mesh((n_rows, clients_shards), (REPLICA_AXIS, CLIENT_AXIS))
    return _current


def position(mesh) -> Optional[tuple[int, int, int, int]]:
    """(replica row, client block, rows, blocks) of this rank in a 1-D
    (replicas) or 2-D (replicas, clients) run mesh; None when the rank is
    outside it."""
    c = mesh.get_coordinate()
    if c is None:
        return None
    shape = tuple(mesh.shape)
    return (c[0], c[1] if len(c) > 1 else 0, shape[0],
            shape[1] if len(shape) > 1 else 1)


def client_group(axis):
    """The process group of a client axis: a ProcessGroup as it is, a mesh
    with a clients dimension its group for this rank, or the axis name
    (`CLIENT_AXIS`) the last client mesh's group."""
    from torch.distributed import ProcessGroup
    if isinstance(axis, ProcessGroup):
        return axis
    mesh = axis
    if isinstance(axis, str):
        if axis != CLIENT_AXIS or _current is None:
            raise ValueError(f"no client mesh has axis {axis!r}: make one "
                             f"with make_run_mesh(n, clients_shards > 1), "
                             f"or pass a process group")
        mesh = _current
    return mesh.get_group(CLIENT_AXIS)


def group_rank(group) -> tuple[int, int]:
    """(index of this rank in `group`, the group's size)."""
    import torch.distributed as dist
    return dist.get_rank(group), dist.get_world_size(group)


def _outside_conditional(what: str) -> None:
    from repro_torch.engine import graph_flow
    if graph_flow.depth():
        raise RuntimeError(f"{what} inside a conditional node of a captured "
                           "graph: collectives run outside them")


def all_gather_words(words: torch.Tensor, group) -> torch.Tensor:
    """(G, n) int32: every rank's (n,) int32 `words`, in group order, one
    collective."""
    import torch.distributed as dist
    _outside_conditional("all_gather")
    size = dist.get_world_size(group)
    out = torch.empty((size * words.numel(),), dtype=torch.int32,
                      device=words.device)
    gather = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor
    gather(out, words.contiguous(), group=group)
    COLLECTIVES["all_gather"] += 1
    return out.reshape(size, words.numel())


def all_reduce_words(words: torch.Tensor, group) -> torch.Tensor:
    """Sum the (n,) int32 `words` over the group in place, one collective."""
    import torch.distributed as dist
    _outside_conditional("all_reduce")
    dist.all_reduce(words, group=group)
    COLLECTIVES["all_reduce"] += 1
    return words


def pack_words(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """The tensors' bytes one after the other, each padded with zeros to 16
    bytes (whole int32 words, and every tensor aligned for any dtype), as
    one (n,) int32 tensor (bool goes as uint8)."""
    parts = []
    for t in tensors:
        b = t.contiguous().reshape(-1).view(torch.uint8)
        pad = -b.numel() % ALIGN
        parts.append(torch.cat([b, b.new_zeros((pad,))]) if pad else b)
    return torch.cat(parts).view(torch.int32)


def unpack_blocks(gathered: torch.Tensor, likes: Sequence[torch.Tensor]
                  ) -> list:
    """Invert `pack_words` over the (G, n) rows of `all_gather_words`: for
    each (n_local, ...) block shaped like `likes[i]`, the G blocks
    concatenated along the leading axis, (G * n_local, ...)."""
    rows = gathered.view(torch.uint8).reshape(gathered.shape[0], -1)
    out, off = [], 0
    for like in likes:
        n = like.numel() * like.element_size()
        part = rows[:, off:off + n].reshape(-1)
        out.append(part.view(like.dtype).reshape(
            (gathered.shape[0] * like.shape[0],) + tuple(like.shape[1:])))
        off += n + (-n % ALIGN)
    return out
