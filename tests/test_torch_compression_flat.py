"""The port's flat codec layer (`repro_torch.federated.compression`'s
`FLAT_CODECS`, `flat_roundtrip`, `flat_codec_roundtrip`,
`flat_codec_nbytes`) against its per-leaf codecs and against the
reference's flat layer, on the same numpy inputs.

Every comparison is bitwise: both packages run the same IEEE operations
eagerly (true division by the scale, round half to even, one product) and
keep the same set (the k largest |x|, ties lowest index first), the
contract `tests/test_compression.py` states for the reference.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.federated import compression as jax_comp
from repro_torch.federated.compression import (
    CODECS, FLAT_CODECS, codec_nbytes, codec_roundtrip, flat_codec_nbytes,
    flat_codec_roundtrip, flat_roundtrip, flat_sizes, topk_keep_mask,
)
from repro_torch.tree import tree_leaves

CODEC_NAMES = sorted(CODECS)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Six test files run at once: one intra-op thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _odd_tree(seed: int) -> dict:
    """numpy leaves of ragged sizes (53, 7, 130): exact |.| ties planted in
    `a` and an all-zero leaf, the top-k tie-break and quant8 zero-guard
    edge cases of the reference's `_odd_tree`."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(53).astype(np.float32)
    a[3], a[11] = a[40], -a[40]
    return {"a": a, "z": np.zeros(7, np.float32),
            "b": {"w": rng.standard_normal((10, 13)).astype(np.float32)}}


def _new(tree: dict, seed: int) -> dict:
    rng = np.random.default_rng(seed)

    def bump(x):
        return (x + 0.03 * rng.standard_normal(x.shape)).astype(np.float32)
    return {"a": bump(tree["a"]), "z": bump(tree["z"]),
            "b": {"w": bump(tree["b"]["w"])}}


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _jax(tree):
    if isinstance(tree, dict):
        return {k: _jax(v) for k, v in tree.items()}
    return jnp.asarray(tree)


def _assert_trees_bitwise(got, want):
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        np.testing.assert_array_equal(np.asarray(g).view(np.int32),
                                      np.asarray(w).view(np.int32))


def _jax_leaves(tree):
    """The reference tree's leaves in sorted-key order (jax.tree.leaves)."""
    return [tree["a"], tree["b"]["w"], tree["z"]]


@pytest.mark.parametrize("codec", CODEC_NAMES)
@pytest.mark.parametrize("seed", [0, 1])
def test_flat_equals_per_leaf_and_reference_bitwise(codec, seed):
    ref, new = _odd_tree(seed), _new(_odd_tree(seed), seed + 10)
    got = flat_codec_roundtrip(codec, _torch(new), _torch(ref))
    _assert_trees_bitwise(got, codec_roundtrip(codec, _torch(new),
                                               _torch(ref)))
    want = jax_comp.flat_codec_roundtrip(codec, _jax(new), _jax(ref))
    for g, w in zip(tree_leaves(got), _jax_leaves(want)):
        np.testing.assert_array_equal(g.numpy().view(np.int32),
                                      np.asarray(w).view(np.int32))


@pytest.mark.parametrize("codec", CODEC_NAMES)
def test_flat_nbytes_equal(codec):
    tree = _torch(_odd_tree(0))
    n = flat_codec_nbytes(codec, tree)
    assert n == codec_nbytes(codec, tree)
    assert n == jax_comp.flat_codec_nbytes(codec, _jax(_odd_tree(0)))
    assert flat_sizes(tree) == (53, 130, 7)


def test_topk_keep_mask_breaks_ties_lowest_index_first():
    seg = torch.tensor([[1.0, -3.0, 3.0, 0.5, -3.0],
                        [0.0, 0.0, 0.0, 0.0, 0.0]])
    keep = topk_keep_mask(seg, 2)
    assert keep.tolist() == [[False, True, True, False, False],
                             [True, True, False, False, False]]
    want = jax_comp.topk_keep_mask(jnp.asarray(seg.numpy()), 2)
    np.testing.assert_array_equal(keep.numpy(), np.asarray(want))


@pytest.mark.parametrize("codec", CODEC_NAMES)
def test_flat_leading_axes_and_vmap_equal_per_row_calls(codec):
    """A (2, 3, D) batch and `torch.func.vmap` over rows equal the
    per-row calls bitwise (the codecs act along the last axis)."""
    tree = _torch(_odd_tree(2))
    sizes = flat_sizes(tree)
    flat = torch.cat([x.reshape(-1) for x in tree_leaves(tree)])
    rows = torch.stack([flat, 2.0 * flat, torch.zeros_like(flat),
                        -flat, 0.5 * flat, flat.flip(0)])
    one = [flat_roundtrip(codec, r, sizes) for r in rows]
    batched = flat_roundtrip(codec, rows.reshape(2, 3, -1), sizes)
    mapped = torch.func.vmap(lambda r: flat_roundtrip(codec, r, sizes))(rows)
    for i, want in enumerate(one):
        assert torch.equal(batched.reshape(6, -1)[i], want)
        assert torch.equal(mapped[i], want)


def test_flat_codecs_registry_complete():
    assert set(FLAT_CODECS) == set(CODECS) == set(jax_comp.FLAT_CODECS)
    for fc in FLAT_CODECS.values():
        assert callable(fc.encode) and callable(fc.decode)
        assert callable(fc.nbytes)


@pytest.mark.parametrize("n,seed", [(1, 0), (2, 1), (7, 2), (9, 3),
                                    (10, 4), (11, 5), (31, 6), (64, 7),
                                    (99, 8), (128, 9), (157, 10), (200, 11)])
def test_flat_roundtrip_size_sweep(n, seed):
    """The reference's property sweep as fixed cases: for each size every
    codec's flat roundtrip equals the per-leaf codec and the reference's
    flat roundtrip bitwise, and a one-row batch equals the row."""
    rng = np.random.default_rng(seed)
    ref = {"w": rng.standard_normal(n).astype(np.float32)}
    new = {"w": (ref["w"] * np.float32(1.7) + np.float32(0.1))}
    for codec in CODEC_NAMES:
        got = flat_codec_roundtrip(codec, _torch(new), _torch(ref))["w"]
        want = codec_roundtrip(codec, _torch(new), _torch(ref))["w"]
        assert torch.equal(got, want), codec
        jax_got = jax_comp.flat_codec_roundtrip(codec, _jax(new), _jax(ref))
        np.testing.assert_array_equal(got.numpy().view(np.int32),
                                      np.asarray(jax_got["w"]).view(np.int32))
        delta = torch.from_numpy(new["w"] - ref["w"])
        assert torch.equal(flat_roundtrip(codec, delta[None], (n,))[0],
                           flat_roundtrip(codec, delta, (n,)))
