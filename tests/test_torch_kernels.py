"""The port's kernel modules against the reference's Pallas kernels.

On the CPU each port wrapper runs its plain PyTorch version; these tests
hold that version against the reference kernel run in interpret mode and
against the reference's jnp oracle, on the same numpy-seeded inputs.  The
CUDA kernels themselves are held against the same plain versions on the
card (tests/test_torch_gpu.py, chip_smoke.py).

Tolerances: prefix_avg f32 at 2e-6 absolute (the two frameworks round the
same left-to-right walk; a 4-position walk on unit-scale inputs differs by
a few ulp), bf16 at one bf16 ulp of the output scale (8e-3); ce_loss at
1e-5 relative (logsumexp's exp/log differ across libraries).
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ce_loss.kernel import ce_loss_kernel as jax_ce_kernel
from repro.kernels.ce_loss.ops import ce_loss as jax_ce_loss
from repro.kernels.ce_loss.ref import ce_loss_ref as jax_ce_ref
from repro.kernels.prefix_avg.kernel import prefix_avg_kernel as jax_pa_kernel
from repro.kernels.prefix_avg.ops import prefix_avg as jax_prefix_avg
from repro.kernels.prefix_avg.ref import prefix_avg_ref as jax_pa_ref
from repro_torch import kernels
from repro_torch.kernels.ce_loss.kernel import ce_loss_cuda, launch_plan
from repro_torch.kernels.ce_loss.ops import ce_loss
from repro_torch.kernels.ce_loss.ref import ce_loss_ref
from repro_torch.kernels.prefix_avg.kernel import (
    MAX_LEAVES, launch_plan as prefix_plan, prefix_avg_cuda, walks_per_block,
)
from repro_torch.kernels.prefix_avg.ops import prefix_avg
from repro_torch.kernels.prefix_avg.ref import prefix_avg_ref, walk_weights


def _walks(rng, r, m):
    return np.stack([rng.permutation(m) for _ in range(r)]).astype(np.int32)


def _to_torch(a, dtype=None):
    t = torch.from_numpy(np.asarray(a, np.float32))
    return t.to(dtype) if dtype is not None else t


# ------------------------------------------------------------ prefix_avg ----
@pytest.mark.parametrize("m,d,r", [(5, 4096, 6), (3, 2049, 4), (1, 2048, 3),
                                   (4, 6144, 8)])
def test_prefix_avg_plain_matches_reference_kernel_and_ref(m, d, r):
    rng = np.random.default_rng(m * 1000 + d)
    stacked = rng.standard_normal((m, d)).astype(np.float32)
    perms = _walks(rng, r, m)
    n_k = rng.integers(1, 50, size=m).astype(np.float32)
    got = prefix_avg_ref(torch.from_numpy(stacked),
                         torch.from_numpy(perms).long(),
                         torch.from_numpy(n_k)).numpy()
    padded = np.pad(stacked, ((0, 0), (0, (-d) % 2048)))
    want_k = np.asarray(jax_pa_kernel(jnp.asarray(padded), jnp.asarray(perms),
                                      jnp.asarray(n_k), interpret=True))[:, :d]
    want_r = np.asarray(jax_pa_ref(jnp.asarray(stacked), jnp.asarray(perms),
                                   jnp.asarray(n_k)))
    assert got.shape == (r * m, d)
    np.testing.assert_allclose(got, want_k, atol=2e-6, rtol=0)
    np.testing.assert_allclose(got, want_r, atol=2e-6, rtol=0)


def test_prefix_avg_plain_bf16_matches_reference():
    rng = np.random.default_rng(7)
    m, d, r = 4, 4096, 5
    stacked = rng.standard_normal((m, d)).astype(np.float32)
    perms = _walks(rng, r, m)
    n_k = rng.integers(1, 50, size=m).astype(np.float32)
    got = prefix_avg_ref(_to_torch(stacked, torch.bfloat16),
                         torch.from_numpy(perms).long(),
                         torch.from_numpy(n_k))
    assert got.dtype == torch.bfloat16
    want = jax_pa_kernel(jnp.asarray(stacked, jnp.bfloat16),
                         jnp.asarray(perms), jnp.asarray(n_k), interpret=True)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=8e-3,
                               rtol=0)


def test_prefix_avg_identity_walks_are_running_averages():
    """perms = arange: row j is the n-weighted mean of clients 0..j."""
    rng = np.random.default_rng(3)
    m, d = 4, 300
    stacked = rng.standard_normal((m, d)).astype(np.float32)
    n_k = np.array([1.0, 2.0, 3.0, 4.0], np.float32)
    perms = torch.arange(m)[None, :]
    got = prefix_avg_ref(torch.from_numpy(stacked), perms,
                         torch.from_numpy(n_k)).numpy()
    for j in range(m):
        want = (n_k[: j + 1, None] * stacked[: j + 1]).sum(0) / n_k[: j + 1].sum()
        np.testing.assert_allclose(got[j], want, atol=1e-6)


def test_walk_weights_are_exact_running_sizes():
    perms = torch.tensor([[2, 0, 1], [1, 2, 0]])
    scale, ncum = walk_weights(perms, torch.tensor([5.0, 10.0, 15.0]))
    assert scale.tolist() == [[15.0, 5.0, 10.0], [10.0, 15.0, 5.0]]
    assert ncum.tolist() == [[15.0, 20.0, 30.0], [10.0, 25.0, 30.0]]


def test_walk_weights_sum_non_integer_counts_left_to_right():
    """The running size is one float32 sum per position, left to right, as
    the CUDA kernel forms it: 1 + 2^-24 rounds back to 1 at every step
    (a sum kept in double, as torch.cumsum keeps it on the CPU, reaches
    1 + 2^-23), and 2^-24 + 2^-24 + 1 is exact in that order.  On random
    non-integer counts it matches the reference's jnp.cumsum at 2e-6."""
    tiny = 2.0 ** -24
    perms = torch.tensor([[0, 1, 2], [1, 2, 0]])
    _, ncum = walk_weights(perms, torch.tensor([1.0, tiny, tiny]))
    assert ncum.tolist() == [[1.0, 1.0, 1.0], [tiny, 2 * tiny, 1 + 2 * tiny]]
    rng = np.random.default_rng(12)
    perms = _walks(rng, 9, 7)
    n_k = (rng.random(7) * 300).astype(np.float32)
    scale, ncum = walk_weights(torch.from_numpy(perms).long(),
                               torch.from_numpy(n_k))
    want = np.cumsum(n_k[perms], axis=1, dtype=np.float32)
    for j in range(1, 7):                      # numpy's sum, left to right
        want[:, j] = want[:, j - 1] + n_k[perms[:, j]]
    np.testing.assert_array_equal(ncum.numpy(), want)
    np.testing.assert_array_equal(scale.numpy(), n_k[perms])
    np.testing.assert_allclose(
        ncum.numpy(), np.asarray(jnp.cumsum(jnp.asarray(n_k)[perms], axis=1)),
        rtol=2e-6, atol=0)


@pytest.mark.parametrize("d_small", [200, 1000])
def test_prefix_avg_tree_wrapper_matches_reference_ops_routing(d_small):
    """The reference's ops send D < 2048 leaves to its ref and D >= 2048 to
    its kernel; the port's CPU wrapper matches both sides."""
    rng = np.random.default_rng(d_small)
    m, r = 3, 5
    tree = {"layer0": {"w": rng.standard_normal((m, 784, 16)).astype(np.float32),
                       "b": rng.standard_normal((m, d_small)).astype(np.float32)}}
    perms = _walks(rng, r, m)
    n_k = np.array([5.0, 10.0, 15.0], np.float32)
    want = jax_prefix_avg(jax.tree.map(jnp.asarray, tree), jnp.asarray(perms),
                          jnp.asarray(n_k), use_kernel=True, interpret=True)
    before = dict(kernels.LAUNCHES)
    got = prefix_avg({"layer0": {k: torch.from_numpy(v) for k, v in
                                 tree["layer0"].items()}},
                     torch.from_numpy(perms).long(), torch.from_numpy(n_k))
    assert kernels.LAUNCHES == before        # the CPU never counts a launch
    for name in ("w", "b"):
        assert tuple(got["layer0"][name].shape) == \
            want["layer0"][name].shape
        np.testing.assert_allclose(got["layer0"][name].numpy(),
                                   np.asarray(want["layer0"][name]),
                                   atol=2e-6, rtol=0)


def test_prefix_avg_launcher_rejects_cpu_tensors():
    x = torch.zeros((2, 8))
    perms = torch.tensor([[0, 1]])
    n_k = torch.ones(2)
    with pytest.raises(ValueError, match="CUDA"):
        prefix_avg_cuda([x], perms, n_k)
    with pytest.raises(TypeError):
        prefix_avg_cuda([x.double()], perms, n_k)
    for bad in (torch.ones(3), torch.ones((1, 2)), torch.ones(2).double()):
        with pytest.raises(ValueError, match="n_k"):
            prefix_avg_cuda([x], perms, bad)
    with pytest.raises(ValueError, match="int64"):
        prefix_avg_cuda([x], perms.int(), n_k)


# the MLP's six leaves in tree order: layer0/b, layer0/w, layer1/b,
# layer1/w, layer2/b, layer2/w
_MLP_D = (200, 156800, 100, 20000, 10, 1000)


@pytest.mark.parametrize("widths,itemsize,offset,want,total", [
    (_MLP_D, 4, 0, [(4, 0, 1), (4, 1, 154), (4, 155, 1), (4, 156, 20),
                    (1, 176, 1), (4, 177, 1)], 178),
    (_MLP_D, 2, 0, [(8, 0, 1), (8, 1, 77), (1, 78, 1), (8, 79, 10),
                    (1, 89, 1), (8, 90, 1)], 91),
    ((10, 156800), 4, 0, [(1, 0, 1), (4, 1, 154)], 155),
    ((156800, 10), 4, 0, [(4, 0, 154), (1, 154, 1)], 155),
    ((156800, 2049), 4, 0, [(4, 0, 154), (1, 154, 9)], 163),
    ((156800, 1000), 4, 4, [(1, 0, 613), (1, 613, 4)], 617),
    ((20000,), 2, 2, [(1, 0, 79)], 79)])
def test_prefix_avg_launch_plan(widths, itemsize, offset, want, total):
    """A leaf takes 16-byte words (4 f32 or 8 bf16 columns a thread) when D
    is a multiple of the word and its stack and output start on 16-byte
    boundaries, else one column a thread; its column blocks of 256 threads
    follow the previous leaf's along grid.x, all in one launch."""
    base = 1 << 20
    (plans, blocks), = prefix_plan([(d, base + offset, base) for d in widths],
                                   itemsize)
    assert [tuple(p) for p in plans] == want and blocks == total
    (plans, _), = prefix_plan([(d, base, base + offset) for d in widths],
                              itemsize)
    assert [p.vec for p in plans] == [v for v, _, _ in want]


def test_prefix_avg_launch_plan_splits_at_32_leaves():
    """Up to MAX_LEAVES leaves a launch; each launch's blocks start at 0."""
    base = 1 << 20
    leaves = [(d, base, base) for d in (10, 156800) * 33]          # 66
    launches = prefix_plan(leaves, 4)
    assert MAX_LEAVES == 32
    assert [len(p) for p, _ in launches] == [32, 32, 2]
    for plans, blocks in launches:
        assert [p.blk0 for p in plans[:3]] == [0, 1, 155][:len(plans)]
        assert blocks == plans[-1].blk0 + plans[-1].blocks
    assert [b for _, b in launches] == [16 * 155, 16 * 155, 155]
    assert prefix_plan([], 4) == []


def test_prefix_avg_walks_per_block():
    """About 8 prefix models a block (one walk at M = 5), at least one walk:
    short blocks keep the grid's last wave short."""
    assert [walks_per_block(m) for m in (1, 2, 3, 5, 8, 12, 3072)] == \
        [8, 4, 2, 1, 1, 1, 1]


# --------------------------------------------------------------- ce_loss ----
@pytest.mark.parametrize("rows,v", [(8, 2048), (16, 4096), (4, 6144)])
def test_ce_loss_plain_matches_reference_kernel(rows, v):
    rng = np.random.default_rng(rows * v)
    logits = (3 * rng.standard_normal((rows, v))).astype(np.float32)
    labels = rng.integers(0, v, size=rows).astype(np.int32)
    got = ce_loss_ref(torch.from_numpy(logits),
                      torch.from_numpy(labels)).numpy()
    want = np.asarray(jax_ce_kernel(jnp.asarray(logits), jnp.asarray(labels),
                                    interpret=True))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_allclose(
        got, np.asarray(jax_ce_ref(jnp.asarray(logits), jnp.asarray(labels))),
        rtol=1e-5)


def test_ce_loss_plain_bf16_matches_reference():
    rng = np.random.default_rng(11)
    logits = (3 * rng.standard_normal((8, 2048))).astype(np.float32)
    labels = rng.integers(0, 2048, size=8).astype(np.int32)
    got = ce_loss_ref(_to_torch(logits, torch.bfloat16),
                      torch.from_numpy(labels))
    assert got.dtype == torch.float32
    want = jax_ce_kernel(jnp.asarray(logits, jnp.bfloat16),
                         jnp.asarray(labels), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


@pytest.mark.parametrize("v", [10, 2049])
def test_ce_loss_wrapper_matches_reference_ops_routing(v):
    """The reference's ops send V < 2048 to its ref and pad V >= 2048 to its
    kernel; the port's CPU wrapper gives the same mean on both sides."""
    rng = np.random.default_rng(v)
    logits = (2 * rng.standard_normal((32, v))).astype(np.float32)
    labels = rng.integers(0, v, size=32).astype(np.int32)
    want = float(jax_ce_loss(jnp.asarray(logits), jnp.asarray(labels),
                             use_kernel=True, interpret=True))
    before = dict(kernels.LAUNCHES)
    got = ce_loss(torch.from_numpy(logits), torch.from_numpy(labels))
    assert kernels.LAUNCHES == before
    assert got.shape == ()
    np.testing.assert_allclose(float(got), want, rtol=1e-5)


def test_ce_loss_model_axis_scores_each_model_on_the_same_rows():
    rng = np.random.default_rng(5)
    logits = torch.from_numpy(rng.standard_normal((6, 20, 10)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 10, size=20))
    got = ce_loss(logits, labels)
    assert got.shape == (6,)
    for b in range(6):
        torch.testing.assert_close(got[b], ce_loss(logits[b], labels))


def test_ce_loss_launcher_checks():
    with pytest.raises(ValueError, match="CUDA"):
        ce_loss_cuda(torch.zeros((4, 10)), torch.zeros((4,), dtype=torch.int64))
    with pytest.raises(ValueError, match="tile"):
        ce_loss_cuda(torch.zeros((5, 10)), torch.zeros((2,), dtype=torch.int64))
    with pytest.raises(ValueError, match="labels"):
        ce_loss(torch.zeros((4, 10)), torch.zeros((3,), dtype=torch.int64))


@pytest.mark.parametrize("rows,v,variant,blocks", [
    (625000, 10, "rows", 1056),     # the main path: 2442 chunks of 256 rows
    (700, 1, "rows", 3),
    (256, 32, "rows", 1),
    (777, 33, "warp", 98),          # 8 rows per block of 8 warps
    (4096, 4096, "warp", 512),
    (4096, 4097, "block", 1056),
    (4096, 32000, "block", 1056),
    (5, 32000, "block", 5)])
def test_ce_loss_launch_plan(rows, v, variant, blocks):
    """The variant by V (whole rows per thread up to 32, a warp per row
    up to 4096, a block per row above) and the persistent grid: at most
    8 blocks of 256 threads per SM of 132, never more than the work."""
    assert launch_plan(rows, v) == (variant, blocks)
    assert launch_plan(rows, v, n_sms=1).blocks == min(blocks, 8)


# ------------------------------------------------------- routing, build ----
def test_routing_and_counters():
    """CPU tensors take the plain version, meta tensors the kernel's route
    (shapes only, for a dry run's count), any other device raises."""
    assert kernels.use_kernel(torch.zeros(1)) is False
    assert kernels.use_kernel(torch.zeros(1, device="meta")) is True
    with pytest.raises(ValueError):
        kernels.use_kernel(types.SimpleNamespace(device=torch.device("xla")))
    kernels.LAUNCHES["prefix_avg"] += 3
    kernels.reset_launches()
    assert kernels.LAUNCHES == {"prefix_avg": 0, "ce_loss": 0,
                                "cohort_gather": 0, "cohort_gather_shard": 0,
                                "delta_codec": 0, "weighted_avg": 0,
                                "flash_attention": 0,
                                "flash_attention_bwd": 0,
                                "flash_attention_wide": 0,
                                "flash_attention_wide_bwd": 0}


def test_pad_to_matches_reference():
    from repro.kernels import pad_to as jax_pad_to
    x = np.arange(2 * 5, dtype=np.float32).reshape(2, 5)
    np.testing.assert_array_equal(kernels.pad_to(torch.from_numpy(x), 4).numpy(),
                                  np.asarray(jax_pad_to(jnp.asarray(x), 4)))
    assert kernels.pad_to(torch.from_numpy(x), 5).shape == (2, 5)


def test_build_names_the_sources_and_hashes_them():
    srcs = [p.name for p in kernels._sources()]
    assert srcs == ["ce_loss.cu", "cohort_gather.cu", "delta_codec.cu",
                    "flash_attention.cu", "flash_attention_bwd.cu",
                    "flash_attention_wide.cu", "graph_cond.cu",
                    "prefix_avg.cu", "weighted_avg.cu"]
    assert "--use_fast_math" not in kernels.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in kernels.NVCC_FLAGS
    assert len(kernels._digest()) == 16


@pytest.mark.parametrize("dtype,hd,want", [
    (torch.float32, 64, "tc"), (torch.float32, 128, "tc"),
    (torch.float32, 129, "tc_wide"), (torch.float32, 256, "tc_wide"),
    (torch.float32, 257, "cuda_cores"), (torch.bfloat16, 128, "tc"),
    (torch.bfloat16, 129, "tc_wide"), (torch.bfloat16, 256, "tc_wide"),
    (torch.bfloat16, 257, "cuda_cores")])
def test_flash_attention_route_by_dtype_and_head_dim(dtype, hd, want):
    """The kernels a flash call runs (`kernel.py::route`): the tensor-core
    routes up to hd 128, each dtype's wide tensor-core kernels at hd padded
    to 256 above it, the CUDA cores above 256; every head dim above 128
    counts as the wide route, whichever runs it."""
    from repro_torch.kernels.flash_attention.kernel import route, wide
    assert route(dtype, hd) == want
    assert wide(hd) == (hd > 128)
