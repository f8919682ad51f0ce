"""Partition rules: params / optimizer state / batches / caches -> specs
(counterpart of `repro/launch/sharding.py`, rule for rule).

A spec is the port's `PartitionSpec`: a tuple with one entry a dim, each
None (replicated), an axis name, or a tuple of axis names (the dim split
over those axes, the first the major one).  Conventions, as the
reference's:

  * batch dims shard over the batch axes ("pod", "data"; with
    `parallelism="dp"` "model" too), when divisible;
  * heads / d_ff / experts / vocab shard over "model", when divisible
    (hymba's 25 heads and KV heads that do not divide the axis
    replicate instead);
  * fsdp archs also shard the d_model / d_ff dim of the big matrices over
    "data" (all-gathered at use, gradients reduce-scattered);
  * decode KV caches shard KV heads over "model" when divisible, otherwise
    the cache's sequence dim (decode then runs a distributed softmax);
  * SSM params and states shard over heads only when ssm_heads % model == 0.

`shard_tree(tree, specs, mesh)` is `to_named`'s counterpart: where the
reference places a global array by a `NamedSharding`, this returns the
slice of each leaf that this rank of `mesh` holds (`compat.
named_shardings` says which slice).  `unshard_tree` is its inverse, over
the mesh's process groups: every rank gets the whole tree back.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.models.lm.config import ArchConfig
from repro_torch.optim.adamw import AdamWState
from repro_torch.optim.sgd import SGDState

PyTree = Any
Spec = tuple


def P(*dims) -> Spec:
    """A spec: the tuple of its dims' axes (`PartitionSpec(*dims)`)."""
    return tuple(dims)


def map_with_path(fn, tree: PyTree, path: str = "") -> PyTree:
    """`fn(path, leaf)` over a tree of dicts, NamedTuples, lists and
    leaves, the path the reference's `_path_str` ("layers/attn/wq")."""
    def sub(key):
        return f"{path}/{key}" if path else str(key)
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, sub(k)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_with_path(fn, v, sub(f))
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, sub(i))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def _shape(leaf) -> tuple:
    return tuple(getattr(leaf, "shape", ()))


class Rules:
    def __init__(self, cfg: ArchConfig, mesh):
        self.cfg = cfg
        self.mesh = mesh
        self.m = mesh.shape["model"]
        # "dp" parallelism: the model axis joins the batch axes and no param
        # dim is model-sharded (small archs, archs whose heads do not divide)
        self.dp = getattr(cfg, "parallelism", "tp") == "dp"
        if self.dp:
            self.batch_axes = tuple(mesh.axis_names)
        else:
            self.batch_axes = tuple(a for a in mesh.axis_names
                                    if a != "model")
        self.n_batch = 1
        for a in self.batch_axes:
            self.n_batch *= mesh.shape[a]
        self.data = "data" if cfg.fsdp else None
        self.d_fsdp = mesh.shape["data"] if cfg.fsdp else 1

    # -- helpers ----------------------------------------------------------
    def model_if(self, dim: int):
        if self.dp:
            return None
        return "model" if dim % self.m == 0 else None

    def data_if(self, dim: int):
        return self.data if (self.data and dim % self.d_fsdp == 0) else None

    def batch_if(self, dim: int):
        if dim % self.n_batch == 0:
            return (self.batch_axes if len(self.batch_axes) > 1
                    else self.batch_axes[0])
        if len(self.batch_axes) > 1 and dim % self.mesh.shape["data"] == 0:
            return "data"
        return None

    @property
    def ssm_ok(self) -> bool:
        return self.cfg.ssm_heads % self.m == 0 if self.cfg.has_ssm else False

    # -- parameter rules ----------------------------------------------------
    def param_spec(self, path: str, shape: tuple) -> Spec:
        leading = ()
        if path.startswith(("layers/", "enc_layers/")):
            leading = (None,)           # stacked layer axis
            shape = shape[1:]

        def spec(*dims):
            return P(*(leading + dims))

        name = path.split("/")[-1]
        parent = path.split("/")[-2] if "/" in path else ""

        if path == "embed/table":
            return P(None, self.model_if(shape[1]))
        if path == "head/w":
            return P(self.data_if(shape[0]), self.model_if(shape[1]))
        if name == "scale":            # all norm scales replicated
            return spec(*(None,) * len(shape))
        if parent in ("attn", "cross_attn"):
            if name == "wq":
                return spec(self.data_if(shape[0]), self.model_if(shape[1]),
                            None)
            if name in ("wk", "wv"):
                return spec(self.data_if(shape[0]), self.model_if(shape[1]),
                            None)
            if name == "wo":
                return spec(self.model_if(shape[0]), None,
                            self.data_if(shape[2]))
        if parent == "ffn":
            if name in ("w_gate", "w_up"):
                return spec(self.data_if(shape[0]), self.model_if(shape[1]))
            if name == "w_down":
                return spec(self.model_if(shape[0]), self.data_if(shape[1]))
        if parent == "moe":
            if name == "router":
                return spec(None, None)
            if name in ("w_gate", "w_up"):   # (E, D, F)
                return spec(self.model_if(shape[0]), self.data_if(shape[1]),
                            None)
            if name == "w_down":             # (E, F, D)
                return spec(self.model_if(shape[0]), self.data_if(shape[1]),
                            None)
        if parent == "ssm":
            di_ax = "model" if self.ssm_ok else None
            if name in ("proj_z", "proj_x"):
                return spec(self.data_if(shape[0]), di_ax)
            if name == "proj_dt":
                return spec(self.data_if(shape[0]),
                            di_ax if shape[1] % self.m == 0 else None)
            if name == "proj_bc":
                return spec(self.data_if(shape[0]), None)
            if name == "conv_x":
                return spec(None, di_ax)
            if name == "conv_bc":
                return spec(None, None)
            if name == "out_proj":
                return spec(di_ax, self.data_if(shape[1]))
            # A_log / D_skip / dt_bias
            return spec(*(None,) * len(shape))
        # fallback: replicate
        return P(*((None,) * (len(leading) + len(shape))))


def param_specs(cfg: ArchConfig, mesh, params_shape: PyTree) -> PyTree:
    rules = Rules(cfg, mesh)
    return map_with_path(lambda path, leaf: rules.param_spec(path,
                                                             _shape(leaf)),
                         params_shape)


def opt_specs(cfg: ArchConfig, pspecs: PyTree):
    if cfg.optimizer == "sgd":
        return SGDState(momentum=pspecs)
    return AdamWState(mu=pspecs, nu=pspecs, step=P())


def batch_specs(cfg: ArchConfig, mesh, batch_shape: PyTree) -> PyTree:
    rules = Rules(cfg, mesh)

    def one(path, leaf):
        shape = _shape(leaf)
        return P(rules.batch_if(shape[0]), *((None,) * (len(shape) - 1)))

    return map_with_path(one, batch_shape)


def cache_specs(cfg: ArchConfig, mesh, cache_shape: PyTree) -> PyTree:
    """Decode caches: leaves are (L, B, ...) except `pos` (the port's
    Python int; the reference's scalar)."""
    rules = Rules(cfg, mesh)

    def one(name, leaf):
        if name == "pos":
            return P()
        shape = _shape(leaf)
        b = rules.batch_if(shape[1])
        if name in ("k", "v", "cross_k", "cross_v"):
            _, _, c, kh, _ = shape
            if kh % rules.m == 0:
                return P(None, b, None, "model", None)
            if c % rules.m == 0:
                return P(None, b, "model", None, None)   # sequence-sharded
            return P(None, b, None, None, None)
        if name == "ssm_state":       # (L, B, H, P, N)
            h_ax = "model" if rules.ssm_ok else None
            return P(None, b, h_ax, None, None)
        if name in ("ssm_conv_x",):   # (L, B, k, di)
            di_ax = "model" if rules.ssm_ok else None
            return P(None, b, None, di_ax)
        if name == "ssm_conv_bc":
            return P(None, b, None, None)
        return P(*((None,) * len(shape)))

    return map_with_path(one, cache_shape)


def logits_spec(cfg: ArchConfig, mesh, batch: int) -> Spec:
    """Decode-step logits (B, V): batch + vocab sharding when divisible."""
    rules = Rules(cfg, mesh)
    return P(rules.batch_if(batch), rules.model_if(cfg.vocab))


def launch_cfg(cfg: ArchConfig, mesh, shape=None) -> ArchConfig:
    """Arm the model's layout hooks + MoE grouping for `mesh`."""
    rules = Rules(cfg, mesh)
    upd: dict = {
        "mesh_batch_axes": rules.batch_axes,
        "mesh_batch_sizes": tuple(mesh.shape[a] for a in rules.batch_axes),
        "mesh_model_axis": "" if rules.dp else "model",
        "mesh_model_size": 0 if rules.dp else rules.m,
    }
    if cfg.is_moe and shape is not None and cfg.moe_groups == 1:
        # default grouping: one dispatch group per data shard (an explicit
        # cfg.moe_groups override, e.g. from the hillclimb, wins)
        tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                       else 1)
        groups = rules.n_batch
        while groups > 1 and (tokens % groups or tokens // groups < 8):
            groups //= 2
        upd["moe_groups"] = max(groups, 1)
    return dataclasses.replace(cfg, **upd)


# ----------------------------------------------------------- placement ----

def is_spec(x) -> bool:
    return isinstance(x, tuple) and not hasattr(x, "_fields") and all(
        a is None or isinstance(a, (str, tuple)) for a in x)


def map_specs(fn, tree: PyTree, specs: PyTree) -> PyTree:
    """`fn(leaf, spec)` over `tree` and its matching `specs` tree (a spec
    is a leaf of the specs tree)."""
    if is_spec(specs):
        return fn(tree, specs)
    if isinstance(tree, dict):
        return {k: map_specs(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_specs(fn, v, s)
                            for v, s in zip(tree, specs)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_specs(fn, v, s) for v, s in zip(tree, specs))
    return fn(tree, specs)


def shard_tree(tree: PyTree, specs: PyTree, mesh) -> PyTree:
    """This rank's block of every tensor leaf of `tree` (global shapes) by
    its spec: a dim sharded over axes is cut in equal blocks and the block
    of this rank's index along those axes kept, as a contiguous tensor of
    its own (a placed shard, not a view of the global leaf; `meta` leaves
    stay `meta`).  Non-tensor leaves (the cache's `pos`) pass through."""
    def one(leaf, spec):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        for dim, axes in enumerate(spec):
            if axes is None:
                continue
            i, n = mesh.index(axes)
            size = leaf.shape[dim]
            if size % n:
                raise ValueError(f"dim {dim} of size {size} does not split "
                                 f"over {axes} ({n} ranks)")
            leaf = leaf.narrow(dim, i * (size // n), size // n)
        return leaf.contiguous()
    return map_specs(one, tree, specs)


def unshard_tree(tree: PyTree, specs: PyTree, mesh) -> PyTree:
    """The inverse of `shard_tree` on a live mesh: every sharded dim
    all-gathered over its axes (in the mesh's process groups), so every
    rank holds the whole tree again."""
    from repro_torch.launch import collectives as C

    def one(leaf, spec):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        for dim, axes in reversed(list(enumerate(spec))):
            if axes is not None:
                leaf = C.all_gather(leaf, axes, dim=dim, mesh=mesh,
                                    count=False)
        return leaf
    return map_specs(one, tree, specs)


def local_shape(shape: tuple, spec: Spec, mesh) -> tuple:
    """The shape of one rank's block of a leaf of `shape` under `spec`."""
    out = list(shape)
    for dim, axes in enumerate(spec):
        if axes is not None:
            out[dim] //= mesh.index(axes)[1]
    return tuple(out)
