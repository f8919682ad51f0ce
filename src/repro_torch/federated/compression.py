"""Client-upload compression codecs — the paper's Related-Work contrast.

Counterpart of the per-leaf layer of `repro/federated/compression.py`
(`CODECS`, `compress_update`, `codec_roundtrip`, `codec_nbytes`,
`leaf_topk_k`).  Codecs are tree -> (payload, nbytes) encoders with exact
byte accounting and a decode that reconstructs the (lossy) update, applied
to the delta w_k - w^t:

  * identity        — float32 baseline
  * quant8          — per-leaf symmetric int8 quantisation (4x)
  * topk            — magnitude top-k sparsification with int32 indices,
                      k as a fraction of each leaf
  * quant8_topk     — both (sparsify, then quantise the kept values)

Top-k keeps the k largest magnitudes with ties broken lowest index first,
as `lax.top_k` does: a stable descending sort, never `torch.topk`, whose
tie order is unspecified.  `jnp.round` and `torch.round` both round half
to even.
"""
from __future__ import annotations

import math
from functools import partial
from typing import Any, NamedTuple

import torch

from repro_torch.core.aggregation import tree_add, tree_sub
from repro_torch.tree import tree_leaves, tree_map

Params = Any

TOPK_FRAC = 0.1  # default sparsification fraction for the top-k codecs


class Encoded(NamedTuple):
    payload: Any         # codec-specific representation
    nbytes: int          # exact wire size of the payload


def _leaf_bytes(x: torch.Tensor) -> int:
    return int(x.numel()) * x.element_size()


def _is_payload(x) -> bool:
    return isinstance(x, dict) and ("q" in x or "idx" in x)


def leaf_topk_k(n: int, frac: float = TOPK_FRAC) -> int:
    """Per-leaf k for the sparse codecs."""
    return max(1, int(n * frac))


def _quant8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    # divide by a tensor: PyTorch on CUDA multiplies by the reciprocal of a
    # CPU-scalar divisor, which can differ from x / 127 in the last bit
    scale = torch.clamp_min(torch.max(torch.abs(x)), 1e-12) / torch.tensor(
        127.0, dtype=torch.float32, device=x.device)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


# ----------------------------------------------------------- identity ------
def identity_encode(delta: Params) -> Encoded:
    return Encoded(delta, sum(_leaf_bytes(x) for x in tree_leaves(delta)))


def identity_decode(enc: Encoded) -> Params:
    return enc.payload


# ------------------------------------------------------------- quant8 ------
def quant8_encode(delta: Params) -> Encoded:
    def enc(leaf):
        q, scale = _quant8(leaf)
        return {"q": q, "scale": scale}

    payload = tree_map(enc, delta)
    nbytes = sum(int(x["q"].numel()) + 4
                 for x in tree_leaves(payload, is_leaf=_is_payload))
    return Encoded(payload, nbytes)


def quant8_decode(enc: Encoded) -> Params:
    return tree_map(lambda x: x["q"].to(torch.float32) * x["scale"],
                    enc.payload, is_leaf=_is_payload)


# --------------------------------------------------------------- topk ------
def topk_indices(flat: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest |flat|, ties lowest index first."""
    order = torch.sort(torch.abs(flat), descending=True, stable=True).indices
    return order[:k]


def topk_encode(delta: Params, frac: float = 0.1) -> Encoded:
    def enc(leaf):
        flat = leaf.reshape(-1)
        idx = topk_indices(flat, max(1, int(flat.numel() * frac)))
        return {"idx": idx.to(torch.int32), "val": flat[idx],
                "shape": tuple(leaf.shape)}

    payload = tree_map(enc, delta)
    nbytes = sum(int(x["idx"].numel()) * 4 + _leaf_bytes(x["val"])
                 for x in tree_leaves(payload, is_leaf=_is_payload))
    return Encoded(payload, nbytes)


def _scatter(idx: torch.Tensor, vals: torch.Tensor, shape) -> torch.Tensor:
    flat = torch.zeros(math.prod(shape), dtype=vals.dtype, device=vals.device)
    flat[idx.to(torch.int64)] = vals
    return flat.reshape(shape)


def topk_decode(enc: Encoded) -> Params:
    return tree_map(lambda x: _scatter(x["idx"], x["val"], x["shape"]),
                    enc.payload, is_leaf=_is_payload)


# ----------------------------------------------------------- combined ------
def quant8_topk_encode(delta: Params, frac: float = 0.1) -> Encoded:
    sparse = topk_encode(delta, frac)

    def q(x):
        val, scale = _quant8(x["val"])
        return {**x, "val": val, "scale": scale}

    payload = tree_map(q, sparse.payload, is_leaf=_is_payload)
    nbytes = sum(int(x["idx"].numel()) * (4 + 1) + 4
                 for x in tree_leaves(payload, is_leaf=_is_payload))
    return Encoded(payload, nbytes)


def quant8_topk_decode(enc: Encoded) -> Params:
    return tree_map(
        lambda x: _scatter(x["idx"], x["val"].to(torch.float32) * x["scale"],
                           x["shape"]),
        enc.payload, is_leaf=_is_payload)


CODECS = {
    "identity": (identity_encode, identity_decode),
    "quant8": (quant8_encode, quant8_decode),
    "topk": (partial(topk_encode, frac=TOPK_FRAC), topk_decode),
    "quant8_topk": (partial(quant8_topk_encode, frac=TOPK_FRAC),
                    quant8_topk_decode),
}


def compress_update(codec: str, w_new: Params, w_ref: Params
                    ) -> tuple[Params, int]:
    """Encode w_new relative to w_ref; return (reconstructed w_new, bytes),
    the lossy reconstruction the server receives over the wire."""
    enc_fn, dec_fn = CODECS[codec]
    enc = enc_fn(tree_sub(w_new, w_ref))
    return tree_add(w_ref, dec_fn(enc)), enc.nbytes


def codec_roundtrip(codec: str, w_new: Params, w_ref: Params) -> Params:
    """Encode -> decode without the byte count."""
    return compress_update(codec, w_new, w_ref)[0]


def codec_nbytes(codec: str, tree: Params) -> int:
    """Wire size of one encoded update for a model of `tree`'s shapes (a
    per-run constant: every codec's size depends on leaf shapes only)."""
    enc_fn, _ = CODECS[codec]
    return enc_fn(tree_map(torch.zeros_like, tree)).nbytes
