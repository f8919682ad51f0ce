"""Client-upload compression codecs — the paper's Related-Work contrast.

Counterpart of `repro/federated/compression.py`.  Codecs are
tree -> (payload, nbytes) encoders with exact byte accounting and a decode
that reconstructs the (lossy) update, applied to the delta w_k - w^t:

  * identity        — float32 baseline
  * quant8          — per-leaf symmetric int8 quantisation (4x)
  * topk            — magnitude top-k sparsification with int32 indices,
                      k as a fraction of each leaf
  * quant8_topk     — both (sparsify, then quantise the kept values)

Two layers, as in the reference:

  * the per-leaf codecs (`CODECS`, `compress_update`, `codec_roundtrip`,
    `codec_nbytes`), the parity oracle, which the loop engine runs;
  * the flat layer (`FLAT_CODECS`, `flat_roundtrip`,
    `flat_codec_roundtrip`, `flat_codec_nbytes`): the same codecs over the
    raveled delta with static per-leaf offsets and fixed payload shapes,
    on any leading axes (along the last), bitwise the per-leaf codecs.
    It calls no kernel, as the reference's calls none; the engines' cohort
    codec is the `delta_codec` kernel.

Top-k keeps the k largest magnitudes with ties broken lowest index first,
as `lax.top_k` does: a stable descending sort, never `torch.topk`, whose
tie order is unspecified.  `jnp.round` and `torch.round` both round half
to even.
"""
from __future__ import annotations

import math
from functools import partial
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.core.aggregation import tree_add, tree_sub
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

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


def _quant8(x: torch.Tensor, dim=None) -> tuple[torch.Tensor, torch.Tensor]:
    """int8 codes and f32 scale of x, over all of x or (dim=-1) each row
    along the last axis."""
    # divide by a tensor: PyTorch on CUDA multiplies by the reciprocal of a
    # CPU-scalar divisor, which can differ from x / 127 in the last bit
    top = (torch.max(torch.abs(x)) if dim is None
           else torch.amax(torch.abs(x), dim=dim))
    scale = torch.clamp_min(top, 1e-12) / torch.tensor(
        127.0, dtype=torch.float32, device=x.device)
    div = scale if dim is None else scale[..., None]
    q = torch.clamp(torch.round(x / div), -127, 127).to(torch.int8)
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
    """Indices of the k largest |flat| along the last axis, ties lowest
    index first."""
    order = torch.sort(torch.abs(flat), dim=-1, descending=True,
                       stable=True).indices
    return order[..., :k]


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


_NBYTES: dict = {}


def codec_nbytes(codec: str, tree: Params) -> int:
    """Wire size of one encoded update for a model of `tree`'s shapes (a
    per-run constant: every codec's size depends on leaf shapes only, so
    it is computed once a shape, by encoding zeros, and then looked up:
    the encoding reads the card back)."""
    key = (codec, tuple((tuple(x.shape), x.dtype, x.device.type)
                        for x in tree_leaves(tree)))
    if key not in _NBYTES:
        enc_fn, _ = CODECS[codec]
        _NBYTES[key] = enc_fn(tree_map(torch.zeros_like, tree)).nbytes
    return _NBYTES[key]


# ===================================================== flat-vector layer ====
# The same codecs over the raveled delta with STATIC leaf sizes / offsets:
# fixed payload shapes, each leaf a static slice of the last axis, so a
# leading batch axis (or `torch.func.vmap`) runs every row at once.  Each
# flat codec is bitwise its per-leaf oracle above.

def flat_sizes(tree: Params) -> tuple[int, ...]:
    """Static per-leaf element counts, in `tree_leaves` order."""
    return tuple(math.prod(x.shape) for x in tree_leaves(tree))


def _offsets(sizes: tuple[int, ...]) -> tuple[int, ...]:
    out, off = [], 0
    for n in sizes:
        out.append(off)
        off += n
    return tuple(out)


def topk_keep_mask(seg: torch.Tensor, k: int) -> torch.Tensor:
    """Bool mask of the k largest |seg| along the last axis, ties lowest
    index first: the per-leaf codec's index set, so the flat decode is
    bitwise its scatter."""
    keep = torch.zeros_like(seg, dtype=torch.bool)
    return keep.scatter(-1, topk_indices(seg, k), True)


def _segments(flat: torch.Tensor, sizes) -> list:
    return [flat[..., o:o + n] for o, n in zip(_offsets(sizes), sizes)]


def _dequant(q: torch.Tensor, scale: torch.Tensor, sizes) -> torch.Tensor:
    return torch.cat([seg.to(torch.float32) * scale[..., i:i + 1]
                      for i, seg in enumerate(_segments(q, sizes))], dim=-1)


def flat_identity_encode(flat, sizes, frac=TOPK_FRAC):
    return {"v": flat}


def flat_identity_decode(payload, sizes, frac=TOPK_FRAC):
    return payload["v"]


def flat_identity_nbytes(sizes, frac=TOPK_FRAC):
    return 4 * sum(sizes)


def flat_quant8_encode(flat, sizes, frac=TOPK_FRAC):
    qs, scales = zip(*(_quant8(seg, dim=-1) for seg in _segments(flat,
                                                                  sizes)))
    return {"q": torch.cat(qs, dim=-1), "scale": torch.stack(scales, dim=-1)}


def flat_quant8_decode(payload, sizes, frac=TOPK_FRAC):
    return _dequant(payload["q"], payload["scale"], sizes)


def flat_quant8_nbytes(sizes, frac=TOPK_FRAC):
    return sum(sizes) + 4 * len(sizes)


def _kept(flat, sizes, frac):
    """Each leaf's keep mask and its kept values (zeros elsewhere)."""
    for n, seg in zip(sizes, _segments(flat, sizes)):
        keep = topk_keep_mask(seg, leaf_topk_k(n, frac))
        yield keep, torch.where(keep, seg, 0.0)


def flat_topk_encode(flat, sizes, frac=TOPK_FRAC):
    keeps, vals = zip(*_kept(flat, sizes, frac))
    return {"keep": torch.cat(keeps, dim=-1), "val": torch.cat(vals, dim=-1)}


def flat_topk_decode(payload, sizes, frac=TOPK_FRAC):
    return payload["val"]


def flat_topk_nbytes(sizes, frac=TOPK_FRAC):
    return sum((4 + 4) * leaf_topk_k(n, frac) for n in sizes)


def flat_quant8_topk_encode(flat, sizes, frac=TOPK_FRAC):
    keeps, qs, scales = [], [], []
    for keep, kept in _kept(flat, sizes, frac):
        # max|kept| == max|seg| over the k kept values: the oracle's scale
        q, scale = _quant8(kept, dim=-1)
        keeps.append(keep)
        qs.append(q)
        scales.append(scale)
    return {"keep": torch.cat(keeps, dim=-1), "q": torch.cat(qs, dim=-1),
            "scale": torch.stack(scales, dim=-1)}


def flat_quant8_topk_decode(payload, sizes, frac=TOPK_FRAC):
    return _dequant(payload["q"], payload["scale"], sizes)


def flat_quant8_topk_nbytes(sizes, frac=TOPK_FRAC):
    return sum((4 + 1) * leaf_topk_k(n, frac) + 4 for n in sizes)


class FlatCodec(NamedTuple):
    encode: Callable[..., Any]            # (flat, sizes, frac) -> payload
    decode: Callable[..., torch.Tensor]   # (payload, sizes, frac) -> flat
    nbytes: Callable[..., int]            # (sizes, frac) -> wire bytes


FLAT_CODECS = {
    "identity": FlatCodec(flat_identity_encode, flat_identity_decode,
                          flat_identity_nbytes),
    "quant8": FlatCodec(flat_quant8_encode, flat_quant8_decode,
                        flat_quant8_nbytes),
    "topk": FlatCodec(flat_topk_encode, flat_topk_decode, flat_topk_nbytes),
    "quant8_topk": FlatCodec(flat_quant8_topk_encode, flat_quant8_topk_decode,
                             flat_quant8_topk_nbytes),
}


def flat_roundtrip(codec: str, flat: torch.Tensor, sizes: tuple[int, ...],
                   frac: float = TOPK_FRAC) -> torch.Tensor:
    """Encode -> decode the raveled delta(s) along the last axis."""
    c = FLAT_CODECS[codec]
    return c.decode(c.encode(flat, sizes, frac), sizes, frac)


def flat_codec_roundtrip(codec: str, w_new: Params, w_ref: Params) -> Params:
    """Tree-level roundtrip through the flat layer, bitwise
    `codec_roundtrip`."""
    delta = tree_sub(w_new, w_ref)
    leaves = tree_leaves(delta)
    sizes = flat_sizes(delta)
    rt = flat_roundtrip(codec, torch.cat([x.reshape(-1) for x in leaves]),
                        sizes)
    return tree_add(w_ref, tree_unflatten(delta, [
        seg.reshape(x.shape) for seg, x in zip(_segments(rt, sizes),
                                                leaves)]))


def flat_codec_nbytes(codec: str, tree: Params) -> int:
    """Static wire size via the flat registry; equals `codec_nbytes`."""
    return FLAT_CODECS[codec].nbytes(flat_sizes(tree))
