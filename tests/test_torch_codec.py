"""The port's upload-codec kernel (`delta_codec`) on the CPU, against the
reference's.

The same numpy-seeded inputs go through the reference's `delta_codec_ref`
(and its `delta_codec_roundtrip`, and its Pallas kernel in interpret mode)
and through the port's plain version: every comparison is bitwise, since
both sides round the same IEEE operations (one division, round half to
even, one product) and keep the same set (the k largest |x|, ties lowest
column first).  The port's rowwise roundtrip must also equal its per-client
codecs (`federated/compression.py`), which the loop engine runs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.delta_codec.kernel import delta_codec_kernel as jax_kernel
from repro.kernels.delta_codec.ops import (
    delta_codec_roundtrip as jax_roundtrip,
)
from repro.kernels.delta_codec.ref import delta_codec_ref as jax_ref
from repro_torch import kernels
from repro_torch.federated.compression import (
    TOPK_FRAC, codec_roundtrip, leaf_topk_k,
)
from repro_torch.kernels.delta_codec import (
    delta_codec_ref, delta_codec_roundtrip,
)
from repro_torch.kernels.delta_codec.kernel import (
    MAX_LEAVES, delta_codec_cuda, delta_codec_leaves_cuda, launch_plan,
    leaf_slice, leaf_tables,
)
from repro_torch.tree import tree_leaves

CODECS = ["quant8", "topk", "quant8_topk"]


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32)


def _rows(rng, rows, d):
    """Deltas at the scale of one round of local SGD, with planted -0.0."""
    x = (0.01 * rng.standard_normal((rows, d))).astype(np.float32)
    x[:, ::7] = -0.0
    return x


def _both(x, codec, k):
    got = delta_codec_ref(torch.from_numpy(x), codec, k).numpy()
    want = np.asarray(jax_ref(jnp.asarray(x), codec, k=k))
    return got, want


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("d", [10, 200, 2049, 20000])
def test_plain_codec_bitwise_equals_reference(codec, d):
    rng = np.random.default_rng(d)
    x = _rows(rng, 3, d)
    k = leaf_topk_k(d) if codec != "quant8" else 0
    got, want = _both(x, codec, k)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    if codec != "quant8":
        assert ((got != 0).sum(axis=1) <= k).all()
        assert (np.abs(want) > 0).sum() > 0


@pytest.mark.parametrize("codec", ["topk", "quant8_topk"])
@pytest.mark.parametrize("case", ["ties", "zero_row", "k1", "all_kept"])
def test_plain_codec_edge_rows_bitwise_equal_reference(codec, case):
    """Ties at the threshold keep the lowest columns; an all-zero row keeps
    its first k (signed) zeros; k = 1 keeps the single largest; k = d keeps
    the whole row."""
    rng = np.random.default_rng(7)
    d, k = 300, 30
    x = _rows(rng, 4, d)
    if case == "ties":
        x[0] = np.float32(0.5) * np.sign(rng.standard_normal(d))
        x[1, 100:200] = np.float32(-0.25)           # 100 ties, 30 kept
        x[2, :] = np.float32(0.125)
        x[2, 250] = np.float32(1.0)
    elif case == "zero_row":
        x[0] = 0.0
        x[1] = -0.0
    elif case == "k1":
        k = 1
        x[3, [5, 9]] = np.float32(3.0)               # tie for the top slot
    else:
        k = d
    got, want = _both(x, codec, k)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    if case == "ties":           # the 100 ties are the row's largest |x|
        assert np.flatnonzero(got[1]).tolist() == list(range(100, 130))
    if case == "k1":
        assert np.flatnonzero(got[3]).tolist() == [5]


def _nonfinite_rows(rng, d):
    """Rows a diverging client uploads: a NaN, an inf, a -inf with a NaN of
    another payload, NaNs tied for the top slots, and a finite row."""
    x = _rows(rng, 5, d)
    x[0, 3] = np.nan
    x[1, 7] = np.inf
    x[2, 1] = -np.inf
    x[2, 9] = -np.nan
    x[3, [2, 5, 8]] = np.nan
    x[3, 4] = np.inf
    return x


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("k", [1, 2, 4, 30])
def test_plain_codec_passes_non_finite_values_like_the_reference(codec, k):
    """NaN and inf are not clipped away: a NaN or inf in a row makes its
    quantised entries NaN, and the sparse codecs keep NaNs first (as the
    largest |x|, ties in column order), then infs."""
    rng = np.random.default_rng(11)
    x = _nonfinite_rows(rng, 300)
    got, want = _both(x, codec, k if codec != "quant8" else 0)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    finite = ~np.isnan(want)
    np.testing.assert_array_equal(_bits(got[finite]), _bits(want[finite]))
    assert np.isnan(got[0, 3]) and np.isnan(got[3, 2])
    if codec != "topk":
        assert np.isnan(got[0]).sum() >= (300 if codec == "quant8" else k)


def test_plain_codec_matches_reference_pallas_kernel_in_interpret_mode():
    rng = np.random.default_rng(3)
    d = 2049
    x = _rows(rng, 2, d)
    x[1, 1000:1100] = np.float32(0.03)               # ties above the rest
    padded = jnp.pad(jnp.asarray(x), ((0, 0), (0, 2176 - d)))
    for codec in CODECS:
        k = leaf_topk_k(d) if codec != "quant8" else 0
        want = np.asarray(jax_kernel(padded, codec=codec, k=k, d_true=d,
                                     interpret=True))[:, :d]
        got = delta_codec_ref(torch.from_numpy(x), codec, k).numpy()
        np.testing.assert_array_equal(_bits(got), _bits(want))


def _cohort(rng, m=3):
    params = {"layer0": {"w": rng.standard_normal((40, 52)).astype(np.float32),
                         "b": np.zeros(52, np.float32)},
              "layer1": {"w": rng.standard_normal((52, 10)).astype(np.float32),
                         "b": rng.standard_normal(10).astype(np.float32)}}
    stacked = jax.tree.map(
        lambda p: p[None] + (0.01 * rng.standard_normal((m,) + p.shape)
                             ).astype(np.float32), params)
    return params, stacked


def _torch_tree(tree):
    return jax.tree.map(torch.from_numpy, tree)


@pytest.mark.parametrize("codec", ["identity"] + CODECS)
def test_roundtrip_tree_bitwise_equals_reference_and_per_client_codec(codec):
    """The stacked roundtrip equals, bitwise, the port's own per-client
    codec (the loop engine's path) and `params + delta_codec_ref(delta)`
    with the reference's ref run op by op.

    The reference's jitted `delta_codec_roundtrip` is within float rounding
    of that composition, not bitwise: under `jit` XLA rewrites
    `x / (amax / 127)` as `(x * 127) / amax` and contracts
    `ref + q * scale` into one fused multiply-add.  So the jitted roundtrip
    is held at atol 1e-6 (deltas here are ~0.01, quanta ~3e-4)."""
    rng = np.random.default_rng(11)
    params, stacked = _cohort(rng)
    before = dict(kernels.LAUNCHES)
    got = delta_codec_roundtrip(_torch_tree(stacked), _torch_tree(params),
                                codec)
    assert kernels.LAUNCHES == before       # the CPU never counts a launch
    jitted = jax_roundtrip(jax.tree.map(jnp.asarray, stacked),
                           jax.tree.map(jnp.asarray, params), codec)
    for a, s_leaf, p_leaf, b in zip(tree_leaves(got),
                                    jax.tree.leaves(stacked),
                                    jax.tree.leaves(params),
                                    jax.tree.leaves(jitted)):
        d = p_leaf.size
        if codec == "identity":
            eager = s_leaf
        else:
            k = leaf_topk_k(d) if codec != "quant8" else 0
            delta = s_leaf.reshape(3, d) - p_leaf.reshape(1, d)
            eager = (p_leaf.reshape(1, d) + np.asarray(jax_ref(
                jnp.asarray(delta), codec, k=k))).reshape(s_leaf.shape)
        np.testing.assert_array_equal(_bits(a.numpy()), _bits(eager))
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-6)
    tp = _torch_tree(params)
    for i in range(3):
        client = jax.tree.map(lambda s: torch.from_numpy(s[i]), stacked)
        loop = codec_roundtrip(codec, client, tp)
        for a, b in zip(tree_leaves(got), tree_leaves(loop)):
            np.testing.assert_array_equal(_bits(a[i].numpy()),
                                          _bits(b.numpy()))


def test_roundtrip_uses_the_per_leaf_keep_count():
    rng = np.random.default_rng(2)
    params, stacked = _cohort(rng)
    got = delta_codec_roundtrip(_torch_tree(stacked), _torch_tree(params),
                                "topk")
    for g, p in zip(tree_leaves(got), jax.tree.leaves(params)):
        kept = (g.numpy() != p[None]).reshape(3, -1).sum(axis=1)
        assert (kept <= leaf_topk_k(p.size, TOPK_FRAC)).all()
        assert kept.max() == leaf_topk_k(p.size, TOPK_FRAC)


def test_codec_launcher_and_plain_version_checks():
    x = torch.zeros((2, 8))
    with pytest.raises(ValueError, match="CUDA"):
        delta_codec_cuda(x, "quant8")
    with pytest.raises(TypeError):
        delta_codec_cuda(x.double(), "quant8")
    with pytest.raises(ValueError, match="codec"):
        delta_codec_cuda(x, "zstd")
    with pytest.raises(ValueError, match="codec"):
        delta_codec_ref(x, "zstd")
    with pytest.raises(TypeError):
        delta_codec_cuda(torch.zeros(8), "quant8")
    with pytest.raises(ValueError, match="k must be"):
        delta_codec_cuda(x, "topk", 9)
    with pytest.raises(ValueError, match="codec"):
        delta_codec_leaves_cuda([x], [None], "zstd", [0])
    # an empty stack needs no launch and no keep count
    assert delta_codec_leaves_cuda([], [], "topk", []) == []


_S, _R = torch.zeros((3, 40)), torch.zeros(40)


@pytest.mark.parametrize("stacks,refs,ks,error,match", [
    ([_S.bfloat16()], [None], [4], TypeError, "float32"),
    ([_S], [_R.double()], [4], TypeError, "reference of torch.float64"),
    ([_S[:, ::2]], [None], [4], ValueError, "stack must be contiguous"),
    ([_S], [torch.zeros((40, 2))[:, 0]], [4], ValueError,
     "reference must be contiguous"),
    ([_S, torch.zeros((2, 40))], [_R, _R], [4, 4], ValueError, "same M"),
    ([_S], [torch.zeros(39)], [4], ValueError, "reference of 39"),
    ([_S], [_R], [0], ValueError, "k must be in"),
    ([_S], [_R], [41], ValueError, "k must be in"),
    ([_S], [_R], [4], ValueError, "one CUDA device"),
    ([_S], [None], [4], ValueError, "one CUDA device"),
    ([_S], [_R], [4, 4], ValueError, "zip"),
])
def test_codec_launcher_refuses(stacks, refs, ks, error, match):
    """The tree launcher takes contiguous float32 stacks of one M with a
    reference row of d entries (or none) and a keep count in [1, d], on
    one CUDA device; it checks all of that before it builds a table."""
    with pytest.raises(error, match=match):
        delta_codec_leaves_cuda(stacks, refs, "quant8_topk", ks)


# the MLP's six leaves in tree order: layer0/b, layer0/w, layer1/b,
# layer1/w, layer2/b, layer2/w
_MLP_D = (200, 156800, 100, 20000, 10, 1000)


@pytest.mark.parametrize("widths,offset,ref,want,smem", [
    # the main path: 16-byte words but at d = 10, every slice staged; the
    # widest slice (19,600 columns) sizes the shared memory
    (_MLP_D, 0, True, [(28, 4, True), (19600, 4, True), (16, 4, True),
                       (2500, 4, True), (4, 1, True), (128, 4, True)],
     78400),
    # a stack 4 bytes past a 16-byte boundary takes 4-byte words
    ((156800, 1000), 4, True, [(19600, 1, True), (128, 1, True)], 78400),
    ((156800, 1000), 4, False, [(19600, 1, True), (128, 1, True)], 78400),
    # 220 KB of shared memory a block at most: a slice of 56,320 columns is
    # staged, one of 56,324 is re-read from global memory in every pass
    ((450560, 450561, 3), 0, True, [(56320, 4, True), (56324, 1, False),
                                    (4, 1, True)], 225280),
    ((8_000_000,), 0, False, [(1_000_000, 4, False)], 0),
])
def test_codec_launch_plan(widths, offset, ref, want, smem):
    """Each leaf's row is cut into CLUSTER slices of a multiple of 4
    columns; a leaf takes 16-byte words when d is a multiple of 4 and its
    stack, reference and output start on 16-byte boundaries; the launch's
    shared memory is the widest slice that fits in 220 KB."""
    base = 1 << 20
    plans, got_smem = launch_plan([(d, base + offset, base if ref else 0,
                                    base) for d in widths])
    assert [tuple(p) for p in plans] == want and got_smem == smem
    assert [p.slice for p in plans] == [leaf_slice(d) for d in widths]


@pytest.mark.parametrize("n_leaves", [6, MAX_LEAVES, 70])
def test_codec_leaf_tables(n_leaves):
    """One table of at most MAX_LEAVES leaves a launch, each leaf's seven
    fields (stack, reference or 0, output, d, k, slice, word) in tree
    order, and each launch's shared memory from its own leaves."""
    widths = [_MLP_D[i % 6] for i in range(n_leaves)]
    stacks = [torch.zeros((5, d)) for d in widths]
    refs = [torch.zeros(d) if i % 3 else None for i, d in enumerate(widths)]
    outs = [torch.empty_like(s) for s in stacks]
    ks = [leaf_topk_k(d) for d in widths]
    tables = leaf_tables(list(zip(stacks, refs, outs, ks)))
    assert [n for _, n, _ in tables] == \
        [min(MAX_LEAVES, n_leaves - i) for i in range(0, n_leaves,
                                                      MAX_LEAVES)]
    for t, (fields, n, smem) in enumerate(tables):
        assert len(fields) == 7 * n
        lo = t * MAX_LEAVES
        want_smem = 0
        for j in range(n):
            s, r, o, k = stacks[lo + j], refs[lo + j], outs[lo + j], ks[lo + j]
            d = s.shape[1]
            plan = launch_plan([(d, s.data_ptr(),
                                 0 if r is None else r.data_ptr(),
                                 o.data_ptr())])[0][0]
            assert fields[7 * j:7 * j + 7] == [
                s.data_ptr(), 0 if r is None else r.data_ptr(), o.data_ptr(),
                d, k, plan.slice, plan.vec]
            want_smem = max(want_smem, 4 * plan.slice)
        assert smem == want_smem
