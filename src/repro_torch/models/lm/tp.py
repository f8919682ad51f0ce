"""The LM's tensor-parallel and FSDP layout (Megatron's, over an `LMMesh`).

With an ambient mesh (`launch.compat.set_mesh`) the model's entry points
take the global batch, place it by `launch.sharding.batch_specs` (this
rank's rows, `placed`), and run on this rank's blocks of the params and
caches (`launch.sharding.shard_tree` by `param_specs` / `cache_specs`).
Which dims of a weight are split, and over which axis, the model reads
from the leaf's spec (`Layout.specs`, the cached `param_specs` of the
config and mesh), never from its shape: "model" for heads, d_ff,
experts, vocab, d_inner and the embedding's D, "data" for FSDP's
d_model / d_ff dims.  A cache's layout likewise comes from `cache_specs`
of its global length (`cache_spec`), which the entry points are given.
Then:

  * FSDP weights are all-gathered over "data" at use (`full`), their
    gradients reduce-scattered back;
  * a column-parallel product takes `enter(x)` (identity; the backward
    all-reduces the input's gradient over "model") and a row-parallel one
    ends in `leave(y)` (the all-reduce over "model"), so that every
    replicated tensor, and every replicated weight's gradient, is the same
    on all ranks of a model group; a replicated weight that a rank uses
    only in part (KV heads, the SSM's per-head vectors) is `enter`ed too;
  * the embedding gathers its D columns over "model"; the head is
    vocab-parallel, and so is the loss (`vocab_parallel_ce`);
  * `loss_and_grads` all-reduces each gradient over the batch axes that its
    leaf is not sharded over and divides by the batch shards.

Without a mesh every helper here is the identity and nothing is issued.
"""
from __future__ import annotations

import contextlib
import functools
from typing import NamedTuple, Optional

import torch

from repro_torch.launch import collectives as C

MODEL = "model"
DATA = "data"


class Layout(NamedTuple):
    mesh: object
    rules: object          # launch.sharding.Rules of (cfg, mesh)
    batch: object          # the batch dim's axes (batch_if), or None
    local_batch: int       # this rank's rows
    specs: dict            # "attn/wq" ... -> the leaf's spec (`roles`)


_stack: list = []


def layout() -> Optional[Layout]:
    return _stack[-1] if _stack else None


def _rows(x: torch.Tensor, axes, mesh) -> torch.Tensor:
    return C.block(x, axes, 0, mesh) if axes is not None else x


@contextlib.contextmanager
def placed(cfg, batch: dict, size_key: str):
    """The entry points' placement: with an ambient mesh and no layout
    active, push this call's layout and yield this rank's rows of the
    global `batch` (batch_specs' rule on the leaf `size_key`); else yield
    `batch` as it is."""
    mesh = C.current_mesh()
    if mesh is None or layout() is not None:
        yield batch
        return
    from repro_torch.launch.sharding import Rules
    rules = Rules(cfg, mesh)
    axes = rules.batch_if(batch[size_key].shape[0])
    local = {k: (_rows(v, axes, mesh) if isinstance(v, torch.Tensor) else v)
             for k, v in batch.items()}
    _stack.append(Layout(mesh, rules, axes, local[size_key].shape[0],
                         roles(cfg, mesh)))
    try:
        yield local
    finally:
        _stack.pop()


def model_size() -> int:
    lay = layout()
    return lay.mesh.size(MODEL) if lay is not None else 1


def model_index() -> int:
    lay = layout()
    return lay.mesh.index(MODEL)[0] if lay is not None else 0


def split(role: str, dim: int) -> bool:
    """Whether dim `dim` of the leaf `role` ("ffn/w_up", "head/w", ...;
    a layer's leaf without its stacked layer dim) is split over "model"."""
    lay = layout()
    return lay is not None and lay.specs[role][dim] == MODEL


# ------------------------------------------------------------ the forms --

def enter(x: torch.Tensor) -> torch.Tensor:
    lay = layout()
    return C.enter(x, MODEL, lay.mesh) if lay is not None else x


def leave(x: torch.Tensor) -> torch.Tensor:
    lay = layout()
    return C.leave(x, MODEL, lay.mesh) if lay is not None else x


def psum(x: torch.Tensor) -> torch.Tensor:
    lay = layout()
    return C.psum(x, MODEL, lay.mesh) if lay is not None else x


def gather_model(x: torch.Tensor, dim: int) -> torch.Tensor:
    """All-gather over "model" along `dim`, the backward the rank's block
    (the gathered tensor is used alike on every rank)."""
    lay = layout()
    return C.gather(x, MODEL, dim, "split", lay.mesh) if lay is not None \
        else x


def full(w: torch.Tensor, role: str) -> torch.Tensor:
    """The leaf `role`'s weight `w` with each dim that its spec splits over
    "data" (FSDP's) all-gathered; the gradient reduce-scattered back."""
    lay = layout()
    if lay is None:
        return w
    for dim, axes in enumerate(lay.specs[role]):
        if axes == DATA:
            w = C.gather(w, DATA, dim, "reduce_scatter", lay.mesh)
    return w


def block(x: torch.Tensor, dim: int) -> torch.Tensor:
    """This rank's "model" block of `x` along `dim`."""
    lay = layout()
    return C.block(x, MODEL, dim, lay.mesh) if lay is not None else x


def constrain(cfg, x: torch.Tensor, dims) -> torch.Tensor:
    """The reference's sharding-constraint hook (`_constrain`, at its sites
    around each layer), a no-op unless `launch_cfg` armed the config's mesh
    fields.  The layout here is explicit, so it checks instead: that the
    ambient mesh is the one the config was armed for (its batch axes and
    model size), and that a "batch" dim holds this rank's rows."""
    lay = layout()
    if lay is None or not (cfg.mesh_batch_axes or cfg.mesh_model_axis):
        return x
    rules = lay.rules
    if (tuple(cfg.mesh_batch_axes) != rules.batch_axes
            or cfg.mesh_model_size != (0 if rules.dp else rules.m)):
        raise RuntimeError(f"the config was armed for batch axes "
                           f"{cfg.mesh_batch_axes} and a model axis of "
                           f"{cfg.mesh_model_size}, the mesh has "
                           f"{rules.batch_axes} and {rules.m}")
    for i, d in enumerate(dims):
        if d == "batch" and x.shape[i] != lay.local_batch:
            raise RuntimeError(f"dim {i} of {tuple(x.shape)} is not this "
                               f"rank's {lay.local_batch} rows")
    return x


# ------------------------------------------------------- attention heads --

@functools.lru_cache(maxsize=None)
def kv_index(h0: int, n_q: int, group: int) -> tuple[tuple, int]:
    """The KV heads that query heads h0 .. h0 + n_q - 1 read (head h reads
    h // group) and the local group G': contiguous KV heads each read by G'
    of them when that holds, else one KV head a query head (G' = 1)."""
    kv = [h // group for h in range(h0, h0 + n_q)]
    uniq = sorted(set(kv))
    per = n_q // len(uniq)
    if all(kv.count(u) == per for u in uniq):
        return tuple(uniq), per
    return tuple(kv), 1


def take_heads(t: torch.Tensor, heads: tuple) -> torch.Tensor:
    """t (..., H, hd) at the given heads: a slice when contiguous."""
    lo = heads[0]
    if list(heads) == list(range(lo, lo + len(heads))):
        return t.narrow(-2, lo, len(heads))
    return t.index_select(-2, torch.tensor(heads, device=t.device))


# ------------------------------------------------------------- the loss --

class _VocabCE(torch.autograd.Function):
    """Mean CE over (B, S) tokens of vocab-parallel logits (B, S, V_l) f32
    (this rank's vocab block starts at `v0`): the row max all-reduced with
    max, the sum-exp and the gold logit (from the rank that owns it) with
    sum; the backward (softmax - onehot) * mask / count, all local."""

    @staticmethod
    def forward(ctx, logits, labels, mask, v0, mesh):
        v_l = logits.shape[-1]
        m = C.all_reduce(logits.detach().amax(-1), MODEL, "max", mesh=mesh)
        e = torch.exp(logits - m[..., None])
        local = labels.to(torch.int64) - v0
        mine = (local >= 0) & (local < v_l)
        gold = torch.gather(logits, -1, local.clamp(0, v_l - 1)[..., None]
                            )[..., 0]
        sums = C.all_reduce(torch.stack([e.sum(-1),
                                         torch.where(mine, gold, 0.0)]),
                            MODEL, mesh=mesh)
        per = m + torch.log(sums[0]) - sums[1]
        mf = mask.to(torch.float32)
        count = torch.clamp_min(mf.sum(), 1.0)
        ctx.save_for_backward(e, sums[0], local, mine, mf, count)
        return torch.sum(per * mf) / count

    @staticmethod
    def backward(ctx, g):
        e, total, local, mine, mf, count = ctx.saved_tensors
        grad = e / total[..., None]
        onehot = torch.zeros_like(grad).scatter_(
            -1, local.clamp(0, grad.shape[-1] - 1)[..., None],
            mine[..., None].to(grad.dtype))
        scale = (g * mf / count)[..., None]
        return (grad - onehot) * scale, None, None, None, None


def vocab_parallel_ce(logits: torch.Tensor, labels: torch.Tensor,
                      mask: torch.Tensor) -> Optional[torch.Tensor]:
    """The CE of vocab-sharded logits, or None when they are whole here."""
    lay = layout()
    if not split("head/w", 1):
        return None
    v0 = model_index() * logits.shape[-1]
    return _VocabCE.apply(logits, labels, mask, v0, lay.mesh)


# --------------------------------------------------------- the gradients --

@contextlib.contextmanager
def uncounted():
    """Shape bookkeeping that is no work of the step (meta structs of the
    global tree): run outside any active `launch.compat.Count`."""
    from torch.utils._python_dispatch import _disable_current_modes
    with _disable_current_modes():
        yield


@functools.lru_cache(maxsize=64)
def _param_specs(cfg, sizes, names) -> object:
    from repro_torch.launch.mesh import LMMesh
    from repro_torch.launch.shapes import params_struct
    from repro_torch.launch.sharding import param_specs
    mesh = LMMesh(sizes, names)
    with uncounted():
        return param_specs(cfg, mesh, params_struct(cfg))


def param_specs_of(cfg, mesh):
    return _param_specs(cfg, mesh.sizes, mesh.axis_names)


@functools.lru_cache(maxsize=64)
def _roles(cfg, sizes, names) -> dict:
    from repro_torch.launch.sharding import is_spec
    out: dict = {}

    def walk(t, path):
        if is_spec(t):
            parts = path.split("/")
            stacked = parts[0] in ("layers", "enc_layers")
            out["/".join(parts[-2:])] = t[1:] if stacked else t
        elif isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{path}/{k}" if path else k)
    walk(_param_specs(cfg, sizes, names), "")
    return out


def roles(cfg, mesh) -> dict:
    """Each leaf's spec by its role, "parent/name" ("attn/wq",
    "embed/table"), a layer's without its stacked layer dim.  A role's
    spec is the same in every layer and stack that has it, as the rules
    depend only on the role and the leaf's shape."""
    return _roles(cfg, mesh.sizes, mesh.axis_names)


def cache_spec(cfg, name: str, length: int) -> tuple:
    """The spec of a (B, C, Kh, hd) block of cache leaf `name` ("k",
    "cross_k", ...) of global length `length`, without its layer dim
    (`launch.sharding.cache_specs`)."""
    from repro_torch.launch.sharding import cache_specs
    lay = layout()
    b = lay.local_batch * (lay.mesh.size(lay.batch) if lay.batch is not None
                           else 1)
    with uncounted():
        leaf = torch.empty((cfg.n_layers, b, length, cfg.n_kv_heads, cfg.hd),
                           device="meta")
    return cache_specs(cfg, lay.mesh, {name: leaf})[name][1:]


def sync_grads(grads: list, specs: list) -> list:
    """Each gradient of a rank's loss summed over the batch axes that its
    leaf is not sharded over (FSDP's "data" is summed by the gathers'
    reduce-scatters) and divided by the batch shards: the gradient of the
    global mean loss."""
    lay = layout()
    if lay is None:
        return grads
    rules, out = lay.rules, []
    for g, spec in zip(grads, specs):
        held = set()
        for axes in spec:
            held.update(lay.mesh.axes(axes))
        rest = tuple(a for a in rules.batch_axes if a not in held)
        if rest:
            g = C.all_reduce(g, rest, mesh=lay.mesh)
        out.append(g / rules.n_batch if rules.n_batch > 1 else g)
    return out


def mean_over_batch(x: torch.Tensor) -> torch.Tensor:
    """A per-rank mean (the loss) averaged over the batch shards."""
    lay = layout()
    if lay is None or lay.rules.n_batch == 1:
        return x
    return C.all_reduce(x, lay.rules.batch_axes, mesh=lay.mesh) \
        / lay.rules.n_batch
