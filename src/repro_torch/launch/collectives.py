"""The LMs' collectives over the named axes of an `LMMesh`, counted
(the port's counterpart of the reference's per-device HLO-text parse,
`repro/launch/roofline.py::collective_bytes_from_text`).

Raw collectives, over the process group of `axes` (a name or a tuple of
names) of the ambient mesh (`compat.set_mesh`) or `mesh=`:

    all_reduce(x, axes, op="sum" | "max")   -> the reduction, x's shape
    all_gather(x, axes, dim)                -> the blocks concatenated on dim
    reduce_scatter(x, axes, dim)            -> the sum's block of this rank

Over an axis of one rank each is the identity and issues nothing.  On a
`meta` tensor or a virtual mesh they return an empty tensor of the
result's shape and only count.  On cards NCCL runs them; gloo (the
CPU, and several ranks on one card, where NCCL refuses to run) runs all
three on CPU and CUDA tensors alike, and reduces 16-bit floats here in
float32 (its bf16 support varies by build), cast back after.

Every call is counted by kind, in calls and in result bytes, in the
reference's layout (`collective_bytes()`: `by_kind`, `counts` and
`weighted_total`, all-reduce counted twice for the ring's reduce-scatter
and all-gather phases), globally (`reset()`) and in every active
`launch.compat.Count`, whose aten ops the collective's own work does not
add to.

The model's autograd forms (Megatron's conjugate pairs):

    enter(x, axes)          identity; backward all-reduces the gradient
                            (the input of a column-parallel product)
    leave(x, axes)          all-reduce; backward identity (the output of a
                            row-parallel product, used alike on every rank)
    psum(x, axes)           all-reduce both ways (a partial sum each rank
                            then uses differently, as a norm's variance)
    gather(x, axes, dim, grad="split" | "reduce_scatter")
                            all-gather; backward the rank's block of the
                            gradient ("split": every rank's gradient is the
                            same) or the blocks' sum ("reduce_scatter":
                            FSDP's weights, tokens gathered for a group)
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch

KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute")

BYTES = {k: 0 for k in KINDS}
COUNTS = {k: 0 for k in KINDS}

_ambient: list = []


def reset() -> None:
    for k in KINDS:
        BYTES[k] = 0
        COUNTS[k] = 0


def collective_bytes(by_kind: Optional[dict] = None,
                     counts: Optional[dict] = None) -> dict:
    """The reference's `collective_bytes_from_text` record of the counts
    since `reset()` (or of the given ones)."""
    by_kind = dict(BYTES if by_kind is None else by_kind)
    counts = dict(COUNTS if counts is None else counts)
    total = sum(by_kind.values()) + by_kind["all-reduce"]
    return {"by_kind": by_kind, "counts": counts, "weighted_total": total}


@contextlib.contextmanager
def ambient(mesh):
    """Install `mesh` as the ambient LM mesh (`compat.set_mesh`)."""
    _ambient.append(mesh)
    try:
        yield mesh
    finally:
        _ambient.pop()


def current_mesh():
    """The ambient LM mesh, or None."""
    return _ambient[-1] if _ambient else None


def _mesh(mesh):
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None:
        raise RuntimeError("no LM mesh: install one with "
                           "launch.compat.set_mesh(mesh)")
    return mesh


def _record(kind: str, result: torch.Tensor, axes, mesh) -> None:
    n = result.numel() * result.element_size()
    BYTES[kind] += n
    COUNTS[kind] += 1
    from repro_torch import kernels
    key = tuple(a for a in mesh.axis_names if a in mesh.axes(axes))
    for count in kernels.COUNTERS:
        count.collective(kind, n, key)


@contextlib.contextmanager
def _quiet():
    """The collective's own aten ops, uncounted by the active Counts."""
    from repro_torch import kernels
    with contextlib.ExitStack() as stack:
        for count in kernels.COUNTERS:
            stack.enter_context(count.mute())
        yield


def _virtual(x: torch.Tensor, mesh) -> bool:
    if x.is_meta:
        return True
    if not mesh.live:
        raise RuntimeError(f"a collective over {mesh!r} on a {x.device} "
                           f"tensor: a virtual mesh takes meta tensors")
    return False


def _reduce_op(op: str):
    import torch.distributed as dist
    return {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]


def _widened(group, x: torch.Tensor) -> bool:
    """Whether gloo reduces `x` in float32 (a 16-bit float)."""
    import torch.distributed as dist
    return (dist.get_backend(group) == "gloo" and x.element_size() == 2
            and x.is_floating_point())


def _all_reduce_(buf: torch.Tensor, group, op: str = "sum") -> None:
    """`dist.all_reduce` of `buf` in place."""
    import torch.distributed as dist
    if _widened(group, buf):
        wide = buf.float()
        dist.all_reduce(wide, _reduce_op(op), group=group)
        buf.copy_(wide)
        return
    dist.all_reduce(buf, _reduce_op(op), group=group)


def all_reduce(x: torch.Tensor, axes, op: str = "sum", *, mesh=None,
               count: bool = True) -> torch.Tensor:
    """The sum (or max) of `x` over `axes`, a new tensor."""
    mesh = _mesh(mesh)
    if mesh.size(axes) == 1:
        return x
    with _quiet():
        if _virtual(x, mesh):
            out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
        else:
            out = x.contiguous().clone()
            _all_reduce_(out, mesh.group(axes), op)
    if count:
        _record("all-reduce", out, axes, mesh)
    return out


def all_gather(x: torch.Tensor, axes, dim: int = 0, *, mesh=None,
               count: bool = True) -> torch.Tensor:
    """The ranks' blocks of `x` along `axes`, concatenated on `dim` in
    their order."""
    import torch.distributed as dist
    mesh = _mesh(mesh)
    n = mesh.size(axes)
    if n == 1:
        return x
    dim = dim % x.dim()
    shape = list(x.shape)
    shape[dim] *= n
    with _quiet():
        if _virtual(x, mesh):
            out = x.new_empty(shape)
        else:
            front = x.movedim(dim, 0).contiguous()
            out = front.new_empty((n * front.shape[0],) + front.shape[1:])
            dist.all_gather_into_tensor(out, front, group=mesh.group(axes))
            out = out.movedim(0, dim).contiguous()
    if count:
        _record("all-gather", out, axes, mesh)
    return out


def reduce_scatter(x: torch.Tensor, axes, dim: int = 0, *, mesh=None,
                   count: bool = True) -> torch.Tensor:
    """This rank's block (along `dim`) of the sum of `x` over `axes`."""
    import torch.distributed as dist
    mesh = _mesh(mesh)
    n = mesh.size(axes)
    if n == 1:
        return x
    dim = dim % x.dim()
    if x.shape[dim] % n:
        raise ValueError(f"reduce_scatter of dim {dim} ({x.shape[dim]}) "
                         f"over {n} ranks")
    block = x.shape[dim] // n
    with _quiet():
        if _virtual(x, mesh):
            out = x.narrow(dim, 0, block).new_empty(
                x.narrow(dim, 0, block).shape)
        else:
            group = mesh.group(axes)
            front = x.movedim(dim, 0).contiguous()
            wide = _widened(group, front)
            if wide:
                front = front.float()
            out = front.new_empty((block,) + front.shape[1:])
            dist.reduce_scatter_tensor(out, front, group=group)
            if wide:
                out = out.to(x.dtype)
            out = out.movedim(0, dim).contiguous()
    if count:
        _record("reduce-scatter", out, axes, mesh)
    return out


def block(x: torch.Tensor, axes, dim: int, mesh=None) -> torch.Tensor:
    """This rank's block of `x` along `dim` split over `axes` (no
    communication)."""
    i, n = _mesh(mesh).index(axes)
    if n == 1:
        return x
    size = x.shape[dim] // n
    return x.narrow(dim, i * size, size)


# ------------------------------------------------------ autograd forms ----

class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh):
        ctx.axes, ctx.mesh = axes, mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.axes, mesh=ctx.mesh), None, None


class _Leave(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh):
        return all_reduce(x, axes, mesh=mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh):
        ctx.axes, ctx.mesh = axes, mesh
        return all_reduce(x, axes, mesh=mesh)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.axes, mesh=ctx.mesh), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, dim, grad, mesh):
        ctx.axes, ctx.dim, ctx.grad, ctx.mesh = axes, dim, grad, mesh
        return all_gather(x, axes, dim, mesh=mesh)

    @staticmethod
    def backward(ctx, g):
        if ctx.grad == "split":
            g = block(g, ctx.axes, ctx.dim, ctx.mesh).contiguous()
        else:
            g = reduce_scatter(g, ctx.axes, ctx.dim, mesh=ctx.mesh)
        return g, None, None, None, None


def _applies(x, axes, mesh) -> bool:
    mesh = _mesh(mesh)
    return mesh.size(axes) > 1


def enter(x: torch.Tensor, axes, mesh=None) -> torch.Tensor:
    return _Enter.apply(x, axes, _mesh(mesh)) if _applies(x, axes, mesh) \
        else x


def leave(x: torch.Tensor, axes, mesh=None) -> torch.Tensor:
    return _Leave.apply(x, axes, _mesh(mesh)) if _applies(x, axes, mesh) \
        else x


def psum(x: torch.Tensor, axes, mesh=None) -> torch.Tensor:
    return _Psum.apply(x, axes, _mesh(mesh)) if _applies(x, axes, mesh) \
        else x


def gather(x: torch.Tensor, axes, dim: int, grad: str = "split",
           mesh=None) -> torch.Tensor:
    if not _applies(x, axes, mesh):
        return x
    return _Gather.apply(x, axes, dim % x.dim(), grad, _mesh(mesh))
