"""The counting layer that stands in for XLA's `cost_analysis` and
`memory_analysis` (counterpart of `repro/launch/compat.py`).

`Count` is a dispatch mode.  Under it every aten op runs as it is (on the
card, on the CPU, or on `meta` tensors, where nothing is computed or
allocated) and is counted:

  * FLOPs by `torch.utils.flop_counter`'s formulas (matrix products,
    convolutions, attention), under the peak of the op's dtype (bf16 and
    f16 at the bf16 tensor-core rate, everything else at the float32 rate:
    the port turns TF32 off);
  * bytes: the nbytes of the op's tensor inputs and outputs.  A view or
    metadata op (every output shares an input's storage, or it has no
    tensor output) counts 0, and so does an `empty` (it writes nothing); an
    in-place op counts its mutated argument once read and once written;
  * live bytes, by storage: a storage an op makes is live from that op
    until its last reference goes (a `weakref` finalizer on the storage),
    so the peak holds on `meta` tensors as on the card.  `track(args)`
    counts the step's arguments as live from the start.

A hand-written kernel is counted by its formula (`roofline.kernel_cost`):
its wrapper enters `kernels.counted(name, **shapes)`, which adds the
formula to the innermost active `Count` and mutes the aten ops the wrapper
runs (their storages still count as live).  So a kernel counts the same
whether its CUDA route, its meta route or its plain version on the CPU
ran.

A collective (`launch/collectives.py`) is counted by kind in calls and
result bytes (`collectives`, the reference's `collective_bytes_from_text`
record), and its own aten ops not at all, on every route.

`cost_analysis_of`, `memory_stats_of`, `compiled_flops` and
`compiled_memory_stats` return the reference's keys.  The reference's
"compile" is here one eager run on `meta` copies of the arguments, which
touches no data; a run that fails raises.  So `aot_compile` has no
counterpart: `count_call` on `meta` tensors is it.

`set_mesh(mesh)` installs the ambient LM mesh that the model's collectives
read (the reference's `jax.set_mesh`); `named_shardings(mesh, specs)`
gives each leaf's placement, which block of which dim this rank holds
(the reference's `NamedSharding`s).
"""
from __future__ import annotations

import contextlib
import functools
import threading
import weakref
from typing import Any, Iterator, NamedTuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import kernels
from repro_torch.launch import collectives as C
from repro_torch.launch.roofline import (
    BF16_PEAK_FLOPS, F32_PEAK_FLOPS, HBM_BYTES_PER_S,
)

PEAK_BY_DTYPE = {torch.bfloat16: BF16_PEAK_FLOPS,
                 torch.float16: BF16_PEAK_FLOPS}

_aten = torch.ops.aten
# allocate without writing: no traffic
_NO_TRAFFIC = {_aten.empty.memory_format, _aten.empty_strided.default,
               _aten.empty_like.default, _aten.new_empty.default,
               _aten.new_empty_strided.default}


def _tensors(x) -> Iterator[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


@functools.lru_cache(maxsize=None)
def _mutates(func) -> bool:
    """True when the op writes one of its arguments (in place or out=)."""
    return any(a.alias_info is not None and a.alias_info.is_write
               for a in func._schema.arguments)


def _storage(t: torch.Tensor):
    try:
        return t.untyped_storage()
    except (RuntimeError, NotImplementedError):
        return None


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class Count(TorchDispatchMode):
    """`with Count() as c: step(*args)`; then `c.flops`, `c.bytes`,
    `c.compute_s`, `c.peak_bytes` and `c.summary()`.  FLOPs are kept by
    peak (`flops_by_peak`), the kernels' formula terms by kernel
    (`by_kernel`: calls, FLOPs, bytes)."""

    def __init__(self) -> None:
        super().__init__()
        self.flops_by_peak: dict[float, float] = {}
        self.bytes = 0
        self.by_kernel: dict[str, dict] = {}
        self.argument_bytes = 0
        self.live = 0
        self.peak = 0
        self._storages: dict[int, int] = {}      # live storage -> its bytes
        self._muted = 0
        self._lock = threading.Lock()
        self.collective_by_kind = {k: 0 for k in C.KINDS}
        self.collective_counts = {k: 0 for k in C.KINDS}
        self.collective_by_axes: dict[str, int] = {}

    # ---- the totals ----
    @property
    def flops(self) -> float:
        return sum(self.flops_by_peak.values())

    @property
    def compute_s(self) -> float:
        return sum(f / p for p, f in self.flops_by_peak.items())

    @property
    def memory_s(self) -> float:
        return self.bytes / HBM_BYTES_PER_S

    @property
    def peak_bytes(self) -> int:
        return self.peak

    @property
    def temp_bytes(self) -> int:
        return self.peak - self.argument_bytes

    def summary(self) -> dict:
        return {"flops": self.flops, "bytes_accessed": self.bytes,
                "compute_s": self.compute_s, "memory_s": self.memory_s,
                "peak_bytes": self.peak_bytes,
                "argument_bytes": self.argument_bytes,
                "temp_bytes": self.temp_bytes,
                "kernels": {k: dict(v) for k, v in self.by_kernel.items()},
                "collectives": dict(
                    C.collective_bytes(self.collective_by_kind,
                                       self.collective_counts),
                    by_axes=dict(self.collective_by_axes))}

    def collective(self, kind: str, n_bytes: int, axes: tuple = ()
                   ) -> None:
        """Add one collective of `kind` over `axes` with a result of
        `n_bytes` (`collective_by_axes`: the weighted bytes, all-reduce
        twice, by the axes they cross, which the roofline prices)."""
        self.collective_by_kind[kind] += n_bytes
        self.collective_counts[kind] += 1
        key = "+".join(axes)
        self.collective_by_axes[key] = self.collective_by_axes.get(key, 0) \
            + n_bytes * (2 if kind == "all-reduce" else 1)

    # ---- live memory ----
    def track(self, *trees: Any) -> None:
        """Count the storages of `trees`' tensors (and NamedTuple / list /
        dict members) as the step's arguments, live from the start."""
        for t in _tensors(trees):
            st = _storage(t)
            if st is not None and st._cdata not in self._storages:
                n = self._hold(st)
                self.argument_bytes += n

    def _hold(self, st) -> int:
        key, n = st._cdata, st.nbytes()
        with self._lock:
            self._storages[key] = n
            self.live += n
            self.peak = max(self.peak, self.live)
        fin = weakref.finalize(st, self._free, key)
        fin.atexit = False
        return n

    def _free(self, key: int) -> None:
        with self._lock:
            self.live -= self._storages.pop(key, 0)

    # ---- the kernels ----
    def kernel(self, name: str, flops: float, n_bytes: float,
               peak: float) -> None:
        """Add one call of a hand-written kernel by its formula."""
        rec = self.by_kernel.setdefault(name, {"calls": 0, "flops": 0.0,
                                               "bytes": 0})
        rec["calls"] += 1
        rec["flops"] += flops
        rec["bytes"] += n_bytes
        self.flops_by_peak[peak] = self.flops_by_peak.get(peak, 0.0) + flops
        self.bytes += n_bytes

    @property
    def muted(self) -> bool:
        return self._muted > 0

    @contextlib.contextmanager
    def mute(self):
        """Run the enclosed aten ops uncounted (their storages still
        count as live): a kernel's wrapper, counted by its formula."""
        self._muted += 1
        try:
            yield
        finally:
            self._muted -= 1

    # ---- the mode ----
    def __enter__(self):
        kernels.COUNTERS.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        kernels.COUNTERS.remove(self)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.utils.flop_counter import flop_registry
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = list(_tensors((args, kwargs)))
        outs = list(_tensors(out))
        in_keys = {st._cdata for st in map(_storage, ins) if st is not None}
        if not self._muted:
            formula = flop_registry.get(func._overloadpacket)
            if formula is not None:
                flops = formula(*args, **kwargs, out_val=out)
                peak = PEAK_BY_DTYPE.get(ins[0].dtype, F32_PEAK_FLOPS)
                self.flops_by_peak[peak] = \
                    self.flops_by_peak.get(peak, 0.0) + flops
            self.bytes += self._op_bytes(func, ins, outs, in_keys)
        for t in outs:
            st = _storage(t)
            if (st is not None and st._cdata not in in_keys
                    and st._cdata not in self._storages):
                self._hold(st)
        return out

    @staticmethod
    def _op_bytes(func, ins, outs, in_keys) -> int:
        if func in _NO_TRAFFIC:
            return 0
        if not _mutates(func):
            if not outs:
                return 0        # a metadata query
            if all((st := _storage(o)) is not None and st._cdata in in_keys
                   for o in outs):
                return 0        # a view or an alias
        return sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))


def to_meta(tree: Any) -> Any:
    """`tree` with every tensor replaced by an empty `meta` tensor of its
    shape, dtype and strides (the reference's avals)."""
    if isinstance(tree, torch.Tensor):
        return torch.empty_strided(tree.shape, tree.stride(),
                                   dtype=tree.dtype, device="meta")
    if isinstance(tree, dict):
        return {k: to_meta(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(to_meta(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_meta(v) for v in tree)
    return tree


def count_call(fn, *args, **kwargs) -> Count:
    """Run `fn(*args, **kwargs)` once under a `Count`, its arguments
    tracked as live from the start; the Count."""
    with Count() as c:
        c.track(args, kwargs)
        fn(*args, **kwargs)
    return c


def cost_analysis_of(count: Count) -> dict:
    """The reference's `cost_analysis` keys of a finished Count."""
    return {"flops": float(count.flops),
            "bytes_accessed": float(count.bytes)}


def memory_stats_of(count: Count) -> dict:
    """The reference's `memory_analysis` keys of a finished Count:
    argument and temporary bytes and their peak (arguments included)."""
    return {"argument_bytes": int(count.argument_bytes),
            "temp_bytes": int(count.temp_bytes),
            "peak_bytes": int(count.peak_bytes)}


def compiled_flops(fn, *args, **kwargs) -> float:
    """The FLOPs `fn` runs for these arguments, counted on meta copies of
    them (no data is touched)."""
    return cost_analysis_of(count_call(fn, *to_meta(args),
                                       **to_meta(kwargs)))["flops"]


def compiled_memory_stats(fn, *args, **kwargs) -> dict:
    """`memory_stats_of` for `fn` at these arguments, counted on meta
    copies of them."""
    return memory_stats_of(count_call(fn, *to_meta(args), **to_meta(kwargs)))


# ------------------------------------------------------------ the mesh --

def set_mesh(mesh):
    """Context manager installing `mesh` (an `LMMesh`) as the ambient mesh
    that the LM's collectives and entry points read."""
    return C.ambient(mesh)


class NamedSharding(NamedTuple):
    """Where a leaf lives on `mesh`: its `spec`, and for each dim the
    (index, count) of the block this rank holds ((0, 1): whole)."""
    mesh: Any
    spec: tuple
    blocks: tuple

    def slices(self, shape) -> tuple:
        """This rank's block of a leaf of global `shape`, as slices."""
        out = []
        for n, (i, k) in zip(shape, self.blocks + ((0, 1),) * len(shape)):
            out.append(slice(i * (n // k), (i + 1) * (n // k)))
        return tuple(out)


def named_shardings(mesh, specs: Any) -> Any:
    """Each spec of the tree `specs` (None: replicated) as a
    `NamedSharding` on `mesh`."""
    from repro_torch.launch.sharding import is_spec

    def conv(s):
        s = () if s is None else s
        return NamedSharding(mesh, s, tuple(mesh.index(a) for a in s))

    def walk(t):
        if t is None or is_spec(t):
            return conv(t)
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*(walk(v) for v in t))
        return type(t)(walk(v) for v in t)
    return walk(specs)
