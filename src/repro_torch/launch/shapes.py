"""Assigned input shapes and `meta` stand-ins for the dry-run (counterpart
of `repro/launch/shapes.py`).

No memory is allocated here: every struct is a tensor on
`torch.device("meta")` (a shape and a dtype, no data), the port's
`jax.ShapeDtypeStruct`, including the params, the optimizer state and the
decode caches, which `init_params` / `init_cache` build on `meta` as the
reference's `jax.eval_shape` does.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.models.lm import model as M
from repro_torch.models.lm.config import ArchConfig

META = torch.device("meta")


class InputShape(NamedTuple):
    name: str
    seq_len: int
    global_batch: int
    kind: str        # train | prefill | decode


SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(cfg: ArchConfig, shape: InputShape) -> tuple[bool, str]:
    """long_500k requires a sub-quadratic decode path (DESIGN.md §5)."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "pure full-attention arch: no sub-quadratic 500k decode"
    return True, ""


def pad_vocab(cfg: ArchConfig, multiple: int = 16) -> ArchConfig:
    """Megatron-style vocab padding so the lm head shards over `model`."""
    v = cfg.vocab
    pad = (-v) % multiple
    return dataclasses.replace(cfg, vocab=v + pad) if pad else cfg


def _struct(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def batch_struct(cfg: ArchConfig, shape: InputShape) -> dict:
    """Meta batch for train/prefill kinds."""
    b, s_len = shape.global_batch, shape.seq_len
    dt = M._DTYPES[cfg.dtype]
    batch = {"tokens": _struct((b, s_len), torch.int32)}
    if cfg.frontend == "vision":
        batch["patches"] = _struct((b, cfg.n_frontend_tokens, cfg.d_model),
                                   dt)
    if cfg.frontend == "audio":
        batch["frames"] = _struct((b, cfg.n_frontend_tokens, cfg.d_model),
                                  dt)
    return batch


def decode_structs(cfg: ArchConfig, shape: InputShape) -> tuple[dict, dict]:
    """(cache, batch) meta structs for a decode step (the cache's `pos` is
    the port's Python int)."""
    b, s_len = shape.global_batch, shape.seq_len
    cache = M.init_cache(cfg, b, s_len, device=META)
    batch = {"token": _struct((b,), torch.int32)}
    return cache, batch


def params_struct(cfg: ArchConfig) -> dict:
    return M.init_params(cfg, torch.Generator(), device=META)


def input_specs(cfg: ArchConfig, shape_name: str) -> dict:
    """All abstract inputs for the step function of this (arch, shape)."""
    shape = SHAPES[shape_name]
    if shape.kind in ("train", "prefill"):
        return {"batch": batch_struct(cfg, shape)}
    cache, batch = decode_structs(cfg, shape)
    return {"cache": cache, "batch": batch}
