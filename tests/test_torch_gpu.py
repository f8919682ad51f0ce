"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs a CUDA card (marker `gpu`) and skips without one.
The file imports no JAX, so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py

Tolerances: prefix_avg bitwise (the kernel rounds the same operations as
the plain walk, in the same order); ce_loss means at 1e-5 relative (the
card's expf/logf against PyTorch's logsumexp), per-row losses at 1e-5
relative plus 1e-6 * max|logit| absolute, since logsumexp - gold cancels
on rows the gold logit dominates; cohort_gather and delta_codec bitwise
(a raw copy; the same IEEE division, rounding and keep set; a NaN that
delta_codec makes is held as a NaN, whatever its payload); weighted_avg
bitwise (its plain version is the kernel's fma chain, emulated exactly);
flash_attention at 2e-5 in float32 (split-TF32 products: ~2^-22 of each
product, and f32 sums in another order) and 3e-2
in bf16 (one bf16 rounding of outputs of magnitude ~1, the reference
test's bound), the bf16 route also elementwise at 5e-3 + 1e-2 |want| and
its mean error at 5e-3 of mean |want| (it rounds P to bf16, which moves
an output by at most 2^-8 of sum p |v| / l); the served model card-vs-CPU
at 1e-4 (float32 products in another order).  A grid on the card is held
bitwise to its cells' solo runs on the card, and to the CPU's grid at 1e-4.
"""
import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.faults import FaultSpec
from repro_torch.kernels.ce_loss.kernel import ce_loss_cuda
from repro_torch.kernels.ce_loss.ops import ce_loss
from repro_torch.kernels.ce_loss.ref import ce_loss_ref
from repro_torch.kernels.cohort_gather import (
    cohort_gather, cohort_gather_ref, cohort_take,
)
from repro_torch.kernels.delta_codec import (
    delta_codec_ref, delta_codec_roundtrip,
)
from repro_torch.kernels.delta_codec.kernel import (
    delta_codec_cuda, delta_codec_leaves_cuda, leaf_slice,
)
from repro_torch.kernels.prefix_avg.ops import prefix_avg
from repro_torch.kernels.prefix_avg.ref import prefix_avg_ref
from repro_torch.kernels.weighted_avg import weighted_avg, weighted_avg_ref

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _walks(gen, r, m, device):
    return torch.stack([torch.randperm(m, generator=gen) for _ in range(r)]
                       ).to(device)


@pytest.mark.parametrize("m,d,r,dtype", [
    (5, 20000, 250, torch.float32), (3, 2049, 7, torch.float32),
    (1, 4096, 3, torch.float32), (4, 300, 9, torch.float32),
    (5, 5000, 11, torch.bfloat16), (12, 3001, 13, torch.float32)])
def test_prefix_avg_kernel_bitwise_equals_plain(cuda, m, d, r, dtype):
    gen = torch.Generator().manual_seed(d)
    stacked = torch.randn((m, d), generator=gen).to(cuda, dtype)
    perms = _walks(gen, r, m, cuda)
    n_k = torch.randint(1, 300, (m,), generator=gen).float().to(cuda)
    before = kernels.LAUNCHES["prefix_avg"]
    got = prefix_avg({"w": stacked}, perms, n_k)["w"]
    assert kernels.LAUNCHES["prefix_avg"] == before + 1
    want = prefix_avg_ref(stacked, perms, n_k)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (r * m, d)
    assert torch.equal(got, want)


def _assert_prefix_tree_bitwise(tree, got, perms, n_k):
    m = perms.shape[1]
    for name, x in tree.items():
        want = prefix_avg_ref(x.reshape(m, -1), perms, n_k).reshape(
            (perms.numel(),) + tuple(x.shape[1:]))
        assert got[name].dtype == x.dtype, name
        assert torch.equal(got[name], want), name


def test_prefix_avg_mlp_tree_in_one_launch(cuda):
    """The main path's call: the full-width MLP's six leaves (D = 178,110 in
    all, one of them 10 wide), M = 5, R = 250 walks, in one launch."""
    gen = torch.Generator().manual_seed(18)
    m, r = 5, 250
    widths = {"layer0/w": (784, 200), "layer0/b": (200,),
              "layer1/w": (200, 100), "layer1/b": (100,),
              "layer2/w": (100, 10), "layer2/b": (10,)}
    tree = {k: torch.randn((m,) + s, generator=gen).to(cuda)
            for k, s in widths.items()}
    perms = _walks(gen, r, m, cuda)
    n_k = torch.randint(20, 300, (m,), generator=gen).float().to(cuda)
    before = kernels.LAUNCHES["prefix_avg"]
    got = prefix_avg(tree, perms, n_k)
    assert kernels.LAUNCHES["prefix_avg"] == before + 1
    _assert_prefix_tree_bitwise(tree, got, perms, n_k)


@pytest.mark.parametrize("m,r,dtype,whole", [
    (1, 70, torch.float32, True), (5, 13, torch.float32, False),
    (12, 11, torch.float32, False), (12, 7, torch.bfloat16, True),
    (5, 250, torch.bfloat16, False), (8, 9, torch.float32, False)])
def test_prefix_avg_edge_leaves_in_one_launch(cuda, m, r, dtype, whole):
    """16-byte and one-column leaves side by side (D a multiple of the word
    or not, a leaf narrower than a word, a leaf of rank 3), a view 4 (f32)
    or 2 (bf16) bytes past a 16-byte boundary, M = 1, 5, 8 (the most held
    in registers) and 12 (reloaded), R not a multiple of the walks a block
    takes, and integer or non-integer n_k: one launch, bitwise."""
    gen = torch.Generator().manual_seed(m * 100 + r)
    tree = {f"d{d}": torch.randn((m, d), generator=gen).to(cuda, dtype)
            for d in (2048, 2049, 10, 1001)}
    tree["rank3"] = torch.randn((m, 4, 25), generator=gen).to(cuda, dtype)
    flat = torch.randn((1 + m * 1000,), generator=gen).to(cuda, dtype)
    tree["offset"] = flat[1:].view(m, 1000)
    perms = _walks(gen, r, m, cuda)
    n_k = torch.randint(1, 300, (m,), generator=gen).float()
    if not whole:
        n_k = n_k + torch.rand((m,), generator=gen)
    n_k = n_k.to(cuda)
    before = kernels.LAUNCHES["prefix_avg"]
    got = prefix_avg(tree, perms, n_k)
    assert kernels.LAUNCHES["prefix_avg"] == before + 1
    _assert_prefix_tree_bitwise(tree, got, perms, n_k)


def test_prefix_avg_chunked_streaming_walk(cuda):
    """`sv_chunk > 0`: the streaming walk calls the kernel once per chunk
    of walks, on row slices of the padded perms; every chunk's prefix
    models equal the plain version's on the same slice."""
    from repro_torch.core.shapley_batched import gtg_shapley_streaming
    from repro_torch.tree import tree_leaves
    gen = torch.Generator().manual_seed(7)
    m, n_perms, sv_chunk = 3, 10, 7           # 3 walks a chunk, 4 chunks
    tree = {"w": torch.randn((m, 2, 1000), generator=gen).to(cuda),
            "b": torch.randn((m, 10), generator=gen).to(cuda)}
    w_prev = {k: torch.zeros(v.shape[1:], device=cuda)
              for k, v in tree.items()}
    n_k = (torch.randint(1, 50, (m,), generator=gen).float()
           + 0.5).to(cuda)
    perms = _walks(gen, n_perms, m, cuda)
    seen = []

    def batched(models):
        seen.append(models)
        return torch.stack([x.reshape(x.shape[0], -1).sum(1)
                            for x in tree_leaves(models)]).sum(0)

    before = kernels.LAUNCHES["prefix_avg"]
    gtg_shapley_streaming(
        tree, n_k, w_prev, lambda p: sum(x.sum() for x in tree_leaves(p)),
        batched, perms, sv_chunk=sv_chunk)
    assert kernels.LAUNCHES["prefix_avg"] == before + 4 == before + len(seen)
    padded = torch.cat([perms, torch.arange(m, device=cuda).expand(2, m)])
    for c, models in enumerate(seen):
        _assert_prefix_tree_bitwise(tree, models, padded[3 * c:3 * c + 3],
                                    n_k)


@pytest.mark.parametrize("lo,hi", [(-1, 0), (0, 5)])
def test_prefix_avg_raises_on_perms_out_of_range(cuda, lo, hi):
    stacked = torch.zeros((5, 100), device=cuda)
    perms = _walks(torch.Generator().manual_seed(0), 4, 5, cuda)
    perms[1, 2], perms[3, 0] = lo, hi
    before = kernels.LAUNCHES["prefix_avg"]
    with pytest.raises(ValueError, match=r"perms must index \[0, 5\)"):
        prefix_avg({"w": stacked}, perms, torch.ones(5, device=cuda))
    assert kernels.LAUNCHES["prefix_avg"] == before


def test_prefix_avg_c_entry_refuses_a_bad_launch(cuda):
    """The C entry checks its table, grid and shared memory and returns an
    error instead of launching; the launcher raises on it."""
    from repro_torch.kernels.prefix_avg.kernel import c_args
    stacked = torch.zeros((5, 2000), device=cuda)
    out = torch.empty((20, 2000), device=cuda)
    perms = _walks(torch.Generator().manual_seed(0), 4, 5, cuda)
    (args,) = c_args([(stacked, out)], perms, torch.ones(5, device=cuda))
    lib = kernels.library()
    assert lib.prefix_avg_f32(*args) == 0
    misaligned = list(args[0])
    misaligned[0] += 4
    # (argument index, value): 0 the table, 1 its leaves, 5 M, 6 walks a
    # block, 7 column blocks
    for i, v in ((1, 0),            # no leaves
                 (1, 33),           # more leaves than the table holds
                 (5, 10_000),       # 1.9 MB of walk steps a block
                 (6, 0),            # no walks a block
                 (7, 0),            # no column blocks
                 (7, 1),            # 1,024 columns for a 2,000-wide leaf
                 (0, kernels.host_table(misaligned))):  # stack 4 bytes past
        bad = list(args)                                # 16 on the wide path
        bad[i] = v
        with pytest.raises(RuntimeError, match="prefix_avg"):
            kernels.check_launch(lib.prefix_avg_f32(*bad), "prefix_avg")
    torch.cuda.synchronize()


@pytest.mark.parametrize("rows,v,dtype", [(4096, 10, torch.float32),
                                          (512, 2049, torch.float32),
                                          (64, 32000, torch.float32),
                                          (256, 4096, torch.bfloat16)])
def test_ce_loss_kernel_matches_plain(cuda, rows, v, dtype):
    gen = torch.Generator().manual_seed(v)
    logits = (3 * torch.randn((2, rows, v), generator=gen)).to(cuda, dtype)
    labels = torch.randint(0, v, (rows,), generator=gen).to(cuda)
    before = kernels.LAUNCHES["ce_loss"]
    got = ce_loss(logits, labels)
    assert kernels.LAUNCHES["ce_loss"] == before + 1
    want = torch.mean(ce_loss_ref(logits, labels), dim=-1)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0)
    per = ce_loss_cuda(logits.reshape(-1, v), labels)
    # per row, logsumexp - gold cancels where the gold logit dominates
    atol = 1e-6 * float(logits.float().abs().max())
    torch.testing.assert_close(per, ce_loss_ref(logits, labels).reshape(-1),
                               rtol=1e-5, atol=atol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("v", [1, 10, 31, 32, 33, 4095, 4096, 4097, 32000])
def test_ce_loss_kernel_at_each_variants_edges(cuda, v, dtype):
    """V at the edges of the three variants (rows per thread up to 32,
    a warp per row up to 4096, a block per row above), 3 models x r rows
    (not a multiple of the 256-row chunk or of a block's 8 warps), read
    from a row slice whose start is not 16-byte aligned."""
    from repro_torch.kernels.ce_loss.kernel import (
        ROWS_MAX_V, WARP_MAX_V, launch_plan,
    )
    r = 259 if v <= 4097 else 13
    gen = torch.Generator().manual_seed(v + 1)
    base = (3 * torch.randn((3 * r + 1, v), generator=gen)).to(cuda, dtype)
    logits = base[1:]                     # starts v * itemsize bytes in
    assert logits.is_contiguous()
    labels = torch.randint(0, v, (r,), generator=gen).to(cuda)
    plan = launch_plan(3 * r, v)
    assert plan.variant == ("rows" if v <= ROWS_MAX_V else
                            "warp" if v <= WARP_MAX_V else "block")
    before = kernels.LAUNCHES["ce_loss"]
    got = ce_loss_cuda(logits, labels)
    assert kernels.LAUNCHES["ce_loss"] == before + 1
    want = ce_loss_ref(logits.view(3, r, v), labels).reshape(-1)
    atol = 1e-6 * float(logits.float().abs().max())
    torch.testing.assert_close(got, want, rtol=1e-5, atol=atol)
    torch.testing.assert_close(got.view(3, r).mean(-1),
                               want.view(3, r).mean(-1), rtol=1e-5, atol=0)


def test_main_path_runs_through_the_kernels(cuda):
    from repro_torch.federated.client import ClientConfig
    from repro_torch.federated.server import FLConfig, run_federated
    cfg = FLConfig(n_clients=6, m=3, rounds=3, n_train=600, n_val=100,
                   n_test=100, eval_every=3, shapley_max_iters=6,
                   client=ClientConfig(epochs=1, batches_per_epoch=2,
                                       batch_size=16))
    kernels.reset_launches()
    res = run_federated(cfg)
    # a valued round costs n_perms*M + 2 utility evals, a truncated one 2;
    # each valued round builds the 6 MLP leaves' prefixes in one launch and
    # scores them
    valued = (res.shapley_evals - 2 * cfg.rounds) // (6 * cfg.m)
    assert valued > 0
    assert kernels.LAUNCHES["prefix_avg"] == valued
    assert kernels.LAUNCHES["ce_loss"] == valued
    assert np.isfinite(res.final_acc) and np.isfinite(res.sv_final).all()
    assert tuple(res.params["layer0"]["w"].shape) == (784, 200)
    assert res.params["layer0"]["w"].is_cuda


@pytest.mark.parametrize("over", [
    {"upload_codec": "topk"}, {"upload_codec": "quant8_topk"},
    {"shapley_impl": "serial", "shapley_max_iters": 3},
    {"selector": "power_of_choice"}, {"selector": "s_fedavg"},
    {"selector": "greedyfed_dropout", "rounds": 4}, {"selector": "random"},
    {"selector": "ucb", "upload_codec": "quant8"},
    {"straggler_frac": 0.5, "privacy_sigma": 0.05, "noise_level": 0.01,
     "prox_mu": 0.1},
    {"deadline_s": 0.6, "sv_averaging": "exponential"}])
def test_small_run_on_the_card_matches_the_cpu(cuda, over):
    """The default draws do not depend on the device, so the card's run
    must make the CPU run's choices: equal selections and byte counts,
    params and SVs at 1e-4."""
    from repro_torch.engine.schedule import ScheduleConfig
    from repro_torch.federated.client import ClientConfig
    from repro_torch.federated.server import FLConfig, run_federated
    from repro_torch.tree import tree_leaves
    over = dict(over)
    client = ClientConfig(epochs=2, batches_per_epoch=2, batch_size=16,
                          prox_mu=over.pop("prox_mu", 0.0))
    if "deadline_s" in over:
        over["schedule"] = ScheduleConfig(deadline_s=over.pop("deadline_s"))
    cfg = FLConfig(**{**dict(n_clients=6, m=3, rounds=3, n_train=600,
                             n_val=100, n_test=100, eval_every=3,
                             shapley_max_iters=6, client=client), **over})
    gpu, cpu = run_federated(cfg, device=cuda), run_federated(cfg,
                                                              device="cpu")
    for a, b in zip(gpu.selections, cpu.selections):
        np.testing.assert_array_equal(a, b)
    assert gpu.upload_bytes == cpu.upload_bytes
    assert gpu.shapley_evals == cpu.shapley_evals
    np.testing.assert_allclose(gpu.sv_final, cpu.sv_final, atol=1e-4)
    for a, b in zip(tree_leaves(gpu.params), tree_leaves(cpu.params)):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), atol=1e-4)


def test_centralized_run_on_the_card_matches_the_cpu(cuda):
    from repro_torch.federated.client import ClientConfig
    from repro_torch.federated.server import FLConfig, run_centralized
    from repro_torch.tree import tree_leaves
    cfg = FLConfig(rounds=2, n_train=600, n_val=100, n_test=100,
                   eval_every=1, client=ClientConfig(epochs=2,
                                                     batches_per_epoch=2))
    gpu, cpu = run_centralized(cfg, device=cuda), run_centralized(
        cfg, device="cpu")
    np.testing.assert_allclose([a for _, a in gpu.test_acc],
                               [a for _, a in cpu.test_acc], atol=1e-4)
    for a, b in zip(tree_leaves(gpu.params), tree_leaves(cpu.params)):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), atol=1e-4)


def test_cnn_on_the_card_matches_the_cpu(cuda):
    """cuDNN convolutions with TF32 off give the CPU's float32 logits."""
    from repro_torch.device import resolve_device
    from repro_torch.models.mlp_cnn import make_cnn
    from repro_torch.tree import tree_map
    resolve_device(cuda)
    model = make_cnn()
    params = model.init(torch.Generator().manual_seed(0),
                        torch.device("cpu"))
    x = torch.randn((16, 32, 32, 3), generator=torch.Generator().manual_seed(1))
    want = model.apply(params, x)
    got = model.apply(tree_map(lambda t: t.to(cuda), params), x.to(cuda))
    torch.testing.assert_close(got.cpu(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("n,d,dtype", [
    (50, 9 * 784, torch.float32), (50, 9, torch.int64), (50, 1, torch.int64),
    (50, 1, torch.float32), (11, 3515, torch.bfloat16), (6, 3, torch.bfloat16),
    (9, 2049, torch.int32)])
def test_cohort_gather_kernel_bitwise_equals_plain(cuda, n, d, dtype):
    gen = torch.Generator().manual_seed(d)
    if dtype.is_floating_point:
        table = torch.randn((n, d), generator=gen).to(dtype)
        bits = table.view(torch.int16 if dtype == torch.bfloat16
                          else torch.int32)
        bits[1, ::3] = -(2 ** (bits.element_size() * 8 - 1))   # -0.0
        bits[2, ::2] = -1                                     # NaN payloads
    else:
        table = torch.randint(-2 ** 30, 2 ** 30, (n, d), generator=gen,
                              dtype=dtype)
    table = table.to(cuda)
    ids = torch.tensor([2, 1, n - 1, 2, 0], device=cuda)
    before = kernels.LAUNCHES["cohort_gather"]
    got = cohort_take(table, ids)
    assert kernels.LAUNCHES["cohort_gather"] == before + 1
    want = cohort_gather_ref(table, ids)
    assert got.dtype == dtype and got.shape == (5, d)
    view = {torch.bfloat16: torch.int16, torch.float32: torch.int32}
    assert torch.equal(got.view(view.get(dtype, dtype)),
                       want.view(view.get(dtype, dtype)))


@pytest.mark.parametrize("where", ["cuda", "host"])
def test_cohort_gather_kernel_raises_on_ids_out_of_range(cuda, where):
    """Host ids are checked before the launch: IndexError, and no kernel
    launched.  CUDA ids go to the device-id entry, which reports an id out
    of range in its error word, read back after the launch: IndexError
    too.  Only host ids pass by value, so only they are capped at 256."""
    table = torch.arange(4000, dtype=torch.float32, device=cuda).view(4, 1000)
    make = ((lambda ids: torch.tensor(ids, device=cuda)) if where == "cuda"
            else np.array)
    before = kernels.LAUNCHES["cohort_gather"]
    for bad in ([0, 4], [-1], [2, 1 << 40]):
        with pytest.raises(IndexError):
            cohort_take(table, make(bad))
        with pytest.raises(IndexError):
            cohort_gather({"a": table, "b": table[:2]}, make([3]))
    assert kernels.LAUNCHES["cohort_gather"] == before + (
        6 if where == "cuda" else 0)
    if where == "host":
        with pytest.raises(ValueError):
            cohort_take(table, make([0] * 257))
    else:
        assert torch.equal(cohort_take(table, make([1] * 257)),
                           table[1:2].expand(257, 1000))
    torch.cuda.synchronize()
    assert torch.equal(cohort_take(table, make([3])), table[3:])


@pytest.mark.parametrize("ids", [[7, 31, 2, 49, 18], [5, 5, 0]])
def test_cohort_gather_device_ids_bitwise_with_error_word(cuda, ids):
    """The device-id entry, given the caller's error word, launches once
    for the tree, reads nothing back, and equals the plain gather bitwise;
    an id of N sets the word, which raises when read after the run, and
    leaves the other slots' rows right."""
    from repro_torch.kernels.cohort_gather.kernel import (
        error_word, raise_on_error,
    )
    tree = _gather_tree(torch.Generator().manual_seed(9), cuda)
    words = {torch.bfloat16: torch.int16, torch.float32: torch.int32}
    word = error_word(cuda)
    sel = torch.tensor(ids, device=cuda)
    before = kernels.LAUNCHES["cohort_gather"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = cohort_gather(tree, sel, error=word)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert kernels.LAUNCHES["cohort_gather"] == before + 1
    raise_on_error(word, 50)
    for name, table in tree.items():
        want = cohort_gather_ref(table.reshape(table.shape[0], -1), sel
                                 ).reshape(got[name].shape)
        w = words.get(table.dtype, table.dtype)
        assert torch.equal(got[name].view(w), want.view(w)), name
    bad = sel.clone()
    bad[1] = 50
    got = cohort_gather(tree, bad, error=word)
    assert int(word.item()) == 50
    with pytest.raises(IndexError, match="got 50"):
        raise_on_error(word, 50)
    for name, table in tree.items():
        w = words.get(table.dtype, table.dtype)
        keep = [0] + list(range(2, len(ids)))
        want = cohort_gather_ref(table.reshape(table.shape[0], -1),
                                 sel[keep]).reshape(
            (len(keep),) + got[name].shape[1:])
        assert torch.equal(got[name][keep].view(w), want.view(w)), name


def _gather_tree(gen, cuda):
    """The main path's four client stacks (N = 50: xs 495,488-byte rows,
    ys 1,264, n_valid 8, sigma 4) with -0.0 and NaN payloads, and edge
    leaves: 6-byte bf16 rows, and rows that start 2 and 4 bytes past a
    16-byte boundary (byte and 4-byte words)."""
    xs = torch.randn((50, 158, 784), generator=gen)
    xs.view(torch.int32)[1, 0, ::3] = -(2 ** 31)                 # -0.0
    xs.view(torch.int32)[2, 1, ::2] = 0x7fc01234                 # NaN payload
    bf16 = torch.randn((50, 3), generator=gen).to(torch.bfloat16)
    bf16.view(torch.int16)[4, 1] = -1                            # NaN payload
    tree = {"xs": xs, "ys": torch.randint(0, 10, (50, 158), generator=gen),
            "n_valid": torch.randint(1, 158, (50,), generator=gen),
            "sigma": torch.rand((50,), generator=gen), "bf16": bf16}
    tree = {k: v.to(cuda) for k, v in tree.items()}
    tree["off2"] = torch.randint(-2 ** 15, 2 ** 15, (1 + 50 * 7,),
                                 generator=gen, dtype=torch.int16
                                 ).to(cuda)[1:].view(50, 7)
    off4 = torch.randn((1 + 50 * 8,), generator=gen).to(cuda)
    tree["off4"] = off4[1:].view(50, 8)
    return tree


@pytest.mark.parametrize("ids", [[7, 31, 2, 49, 18], [5, 5, 0]])
def test_cohort_gather_tree_in_one_launch_bitwise(cuda, ids):
    """A whole tree of stacks in one launch, each leaf bitwise its plain
    gather: 16-byte, 4-byte and byte words side by side."""
    tree = _gather_tree(torch.Generator().manual_seed(7), cuda)
    assert tree["off2"].data_ptr() % 4 == 2 and tree["off4"].is_contiguous()
    sel = np.array(ids)
    before = kernels.LAUNCHES["cohort_gather"]
    got = cohort_gather(tree, sel)
    assert kernels.LAUNCHES["cohort_gather"] == before + 1
    words = {torch.bfloat16: torch.int16, torch.float32: torch.int32}
    for name, table in tree.items():
        want = cohort_gather_ref(table.reshape(table.shape[0], -1),
                                 torch.as_tensor(sel, device=cuda)
                                 ).reshape(got[name].shape)
        w = words.get(table.dtype, table.dtype)
        assert got[name].dtype == table.dtype, name
        assert torch.equal(got[name].view(w), want.view(w)), name


def _codec_rows(gen, rows, d):
    x = 0.01 * torch.randn((rows, d), generator=gen)
    x[:, ::7] = -0.0
    return x


@pytest.mark.parametrize("codec", ["quant8", "topk", "quant8_topk"])
@pytest.mark.parametrize("d", [10, 200, 2049, 20000, 156800])
def test_delta_codec_kernel_bitwise_equals_plain(cuda, codec, d):
    gen = torch.Generator().manual_seed(d)
    x = _codec_rows(gen, 5, d).to(cuda)
    k = max(1, int(0.1 * d)) if codec != "quant8" else 0
    before = kernels.LAUNCHES["delta_codec"]
    got = delta_codec_cuda(x, codec, k)
    assert kernels.LAUNCHES["delta_codec"] == before + 1
    want = delta_codec_ref(x, codec, k)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(want.cpu().view(torch.int32),
                       delta_codec_ref(x.cpu(), codec, k).view(torch.int32))


@pytest.mark.parametrize("codec", ["topk", "quant8_topk"])
def test_delta_codec_kernel_ties_zero_rows_and_k1(cuda, codec):
    gen = torch.Generator().manual_seed(3)
    d = 3000
    x = _codec_rows(gen, 6, d)
    x[0] = 0.5 * torch.sign(torch.randn(d, generator=gen))  # all tied
    x[1, 100:2000] = -0.25                                  # 1900 ties
    x[2] = 0.0
    x[3] = -0.0
    x[4, 17] = x[4, 2999] = 3.0                              # tie at the top
    x = x.to(cuda)
    for k in (1, 2, 300, d):
        got = delta_codec_cuda(x, codec, k)
        want = delta_codec_ref(x, codec, k)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), k


def _same_bits_or_both_nan(a, b):
    nan = torch.isnan(b)
    return (torch.equal(torch.isnan(a), nan)
            and torch.equal(a[~nan].view(torch.int32),
                            b[~nan].view(torch.int32)))


@pytest.mark.parametrize("codec", ["quant8", "topk", "quant8_topk"])
@pytest.mark.parametrize("d", [300, 156800])
def test_delta_codec_kernel_passes_non_finite_values_like_plain(cuda, codec,
                                                                d):
    """A diverging client's NaN or inf is not clipped away: the kernel
    makes the plain version's NaNs and equals it bitwise elsewhere."""
    gen = torch.Generator().manual_seed(5)
    x = _codec_rows(gen, 6, d)
    x[0, 3] = float("nan")
    x[1, 7] = float("inf")
    x[2, 1] = float("-inf")
    x.view(torch.int32)[2, 9] = -4194303              # 0xffc00001, a -NaN
    x.view(torch.int32)[3, [2, 5, 8]] = 0x7fc01234    # tied NaN payloads
    x[3, 4] = float("inf")
    x = x.to(cuda)
    for k in ([0] if codec == "quant8" else [1, 2, 4, max(1, d // 10)]):
        got = delta_codec_cuda(x, codec, k)
        want = delta_codec_ref(x, codec, k)
        assert _same_bits_or_both_nan(got, want), k
        assert bool(torch.isnan(got[0, 3])) and bool(torch.isnan(got[3, 2]))


def _roundtrip_plain(stack, ref, codec, k):
    """The tree wrapper's function on one leaf, op by op: ref + rt(w - ref)."""
    m, d = stack.shape[0], ref.numel()
    delta = stack.reshape(m, d) - ref.reshape(1, d)
    return (ref.reshape(1, d) + delta_codec_ref(delta, codec, k)
            ).reshape(stack.shape)


@pytest.mark.parametrize("codec", ["quant8", "topk", "quant8_topk"])
@pytest.mark.parametrize("model", ["mlp", "cnn"])
def test_delta_codec_tree_in_one_launch_bitwise(cuda, model, codec):
    """The batched round's call: every leaf of the MLP (six) or the CNN
    (eight; dense0/w's 524,288 columns are too wide to stage in shared
    memory) at M = 5 in one launch, the delta and the add-back inside it,
    bitwise equal to `params + delta_codec_ref(stack - params)` on the card
    and on the CPU."""
    from repro_torch.models.mlp_cnn import make_cnn, make_mlp
    from repro_torch.tree import tree_leaves, tree_map
    gen = torch.Generator().manual_seed(17)
    params = (make_mlp() if model == "mlp" else make_cnn()).init(
        gen, torch.device("cpu"))
    stacked = tree_map(lambda p: p[None] + 0.01 * torch.randn(
        (5,) + p.shape, generator=gen), params)
    tree_leaves(params)[0][::3] = -0.0    # ref + (+0.0) keeps no -0.0
    on = tree_map(lambda t: t.to(cuda), stacked)
    ref_on = tree_map(lambda t: t.to(cuda), params)
    before = kernels.LAUNCHES["delta_codec"]
    got = delta_codec_roundtrip(on, ref_on, codec)
    assert kernels.LAUNCHES["delta_codec"] == before + 1
    cpu = delta_codec_roundtrip(stacked, params, codec)
    for g, c, s, p in zip(tree_leaves(got), tree_leaves(cpu),
                          tree_leaves(on), tree_leaves(ref_on)):
        k = max(1, int(0.1 * p.numel())) if codec != "quant8" else 0
        want = _roundtrip_plain(s, p, codec, k)
        assert g.shape == s.shape
        assert torch.equal(g.view(torch.int32), want.view(torch.int32))
        assert torch.equal(g.cpu().view(torch.int32), c.view(torch.int32))


def _straddling_rows(gen, d):
    """Rows whose ties cross the cluster's slice boundaries: one value in
    every column; a run of ties over two boundaries among smaller
    entries; ties at the top in the first and last blocks; and plain
    deltas."""
    sl = leaf_slice(d)
    x = _codec_rows(gen, 5, d)
    x[0] = 0.125
    lo, hi = max(0, sl - 50), min(d, 2 * sl + 50)
    x[1, lo:hi] = -0.25
    x[2, [0, d - 1]] = 3.0
    x[3] = 0.5 * torch.sign(torch.randn(d, generator=gen))
    return x, hi - lo


@pytest.mark.parametrize("codec", ["topk", "quant8_topk"])
@pytest.mark.parametrize("d", [10, 2049, 20000, 156800])
def test_delta_codec_ties_straddle_cluster_slices(cuda, codec, d):
    """Ties are ranked in column order across the blocks of a cluster: at
    k = 1, half the run, d // 10 and k = d, through the single-matrix
    launcher and through the tree wrapper with a reference row."""
    gen = torch.Generator().manual_seed(d + 1)
    x, run = _straddling_rows(gen, d)
    ref = torch.randn(d, generator=gen)
    x, ref = x.to(cuda), ref.to(cuda)
    for k in sorted({1, max(1, run // 2), max(1, d // 10), d}):
        got = delta_codec_cuda(x, codec, k)
        want = delta_codec_ref(x, codec, k)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), k
        stack = ref[None] + x
        got = delta_codec_leaves_cuda([stack], [ref], codec, [k])[0]
        want = _roundtrip_plain(stack, ref, codec, k)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), k


@pytest.mark.parametrize("codec", ["quant8", "topk", "quant8_topk"])
@pytest.mark.parametrize("d", [1, 3, 10])
def test_delta_codec_leaf_narrower_than_the_cluster(cuda, codec, d):
    """d = 10 fills 3 of the cluster's 8 blocks (slices of 4 columns);
    the empty blocks still take part in every cluster barrier."""
    gen = torch.Generator().manual_seed(d)
    x = _codec_rows(gen, 6, d)
    x[1] = 0.25
    x[2] = -0.0
    x = x.to(cuda)
    for k in ([0] if codec == "quant8" else range(1, d + 1)):
        got = delta_codec_cuda(x, codec, k)
        want = delta_codec_ref(x, codec, k)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), k


@pytest.mark.parametrize("codec", ["quant8", "topk", "quant8_topk"])
@pytest.mark.parametrize("d", [2049, 156800])
def test_delta_codec_non_finite_values_in_different_blocks(cuda, codec, d):
    """NaNs and infs in slices of different blocks: the abs-max and the
    keep set are combined across the cluster as in one block."""
    gen = torch.Generator().manual_seed(9)
    sl = leaf_slice(d)
    x = _codec_rows(gen, 4, d)
    x[0, [3, 5 * sl + 1]] = float("nan")
    x[1, [sl + 7, 6 * sl]] = float("inf")
    x[1, 2 * sl] = float("-inf")
    x.view(torch.int32)[2, [1, 4 * sl + 2]] = 0x7fc01234
    x[2, [3 * sl + 5, d - 1]] = float("inf")
    x.view(torch.int32)[3, 7 * sl] = -4194303       # 0xffc00001, a -NaN
    x = x.to(cuda)
    for k in ([0] if codec == "quant8" else [1, 2, 3, 4, d // 10]):
        got = delta_codec_cuda(x, codec, k)
        want = delta_codec_ref(x, codec, k)
        assert _same_bits_or_both_nan(got, want), k


def test_delta_codec_mixed_leaves_in_one_launch(cuda):
    """Leaves the launch handles differently side by side: a slice too
    wide for shared memory (re-read from global memory each pass), a stack
    4 bytes off a 16-byte boundary (4-byte words), a leaf without a
    reference row, and 40 leaves in two launches."""
    gen = torch.Generator().manual_seed(23)
    m = 2
    wide = torch.randn((m, 500_000), generator=gen)
    wide_ref = torch.randn(500_000, generator=gen)
    wide[0, 100_000:300_000] = 5.0        # the top 200,000, over 4 blocks
    wide_ref[100_000:300_000] = 0.0
    buf = torch.randn(1 + m * 3000, generator=gen)
    leaves = [(wide, wide_ref),
              (buf[1:].view(m, 3000), torch.randn(3000, generator=gen)),
              (torch.randn((m, 20000), generator=gen), None)]
    leaves += [(torch.randn((m, 100 + i), generator=gen),
                torch.randn(100 + i, generator=gen)) for i in range(37)]
    stacks = [s.to(cuda) for s, _ in leaves]
    refs = [None if r is None else r.to(cuda) for _, r in leaves]
    ks = [max(1, s.shape[1] // 10) for s in stacks]
    before = kernels.LAUNCHES["delta_codec"]
    got = delta_codec_leaves_cuda(stacks, refs, "quant8_topk", ks)
    assert kernels.LAUNCHES["delta_codec"] == before + 2
    for g, s, r, k in zip(got, stacks, refs, ks):
        want = (delta_codec_ref(s, "quant8_topk", k) if r is None else
                _roundtrip_plain(s, r, "quant8_topk", k))
        assert torch.equal(g.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("r,m,d,dtype", [
    (1250, 5, 156800, torch.float32), (1250, 5, 10, torch.float32),
    (7, 3, 2049, torch.float32), (3, 1, 4096, torch.float32),
    (100, 40, 3000, torch.float32), (250, 5, 20000, torch.bfloat16)])
def test_weighted_avg_kernel_matches_plain(cuda, r, m, d, dtype):
    gen = torch.Generator().manual_seed(d + m)
    stacked = torch.randn((m, d), generator=gen).to(cuda, dtype)
    weights = torch.rand((r, m), generator=gen)
    weights = (weights / weights.sum(-1, keepdim=True)).to(cuda)
    before = kernels.LAUNCHES["weighted_avg"]
    got = weighted_avg({"w": stacked}, weights)["w"]
    assert kernels.LAUNCHES["weighted_avg"] == before + 1
    want = weighted_avg_ref(stacked, weights.to(dtype))
    assert got.dtype == dtype and got.shape == (r, d)
    _assert_wavg_close(got, want)


def _assert_wavg_close(got, want):
    # the plain version is the kernel's fma chain, emulated exactly
    assert torch.equal(got, want)


@pytest.mark.parametrize("r,m,widths,dtype", [
    (1250, 5, (200, 156800, 100, 20000, 10, 1000), torch.float32),
    (100, 40, (3000, 10, 2049, 8), torch.float32),
    (250, 5, (20000, 100, 10, 1000), torch.bfloat16)])
def test_weighted_avg_tree_in_one_launch(cuda, r, m, widths, dtype):
    """Every leaf of a tree in one launch, each against the plain version:
    the main path's six MLP leaves (R = 1250 = 250 walks x M = 5), M = 40
    (stack values reloaded chunk by chunk), bf16 leaves with D % 8 != 0
    (one column a thread) beside 16-byte ones, and a leaf whose stack
    starts 4 bytes past a 16-byte boundary."""
    gen = torch.Generator().manual_seed(m + len(widths))
    tree = {f"l{i}": torch.randn((m, d), generator=gen).to(cuda, dtype)
            for i, d in enumerate(widths)}
    flat = torch.randn((1 + m * 1000,), generator=gen).to(cuda, dtype)
    tree["offset"] = flat[1:].view(m, 1000)
    weights = torch.rand((r, m), generator=gen)
    weights = (weights / weights.sum(-1, keepdim=True)).to(cuda)
    before = kernels.LAUNCHES["weighted_avg"]
    got = weighted_avg(tree, weights)
    assert kernels.LAUNCHES["weighted_avg"] == before + 1
    for name, x in tree.items():
        assert got[name].dtype == dtype and got[name].shape == (r,) + tuple(
            x.shape[1:]), name
        _assert_wavg_close(got[name], weighted_avg_ref(x, weights.to(dtype)))


def test_weighted_avg_mixed_dtypes_launch_once_per_dtype(cuda):
    gen = torch.Generator().manual_seed(11)
    tree = {"a": torch.randn((5, 300), generator=gen).to(cuda),
            "b": torch.randn((5, 4, 6), generator=gen).to(cuda,
                                                          torch.bfloat16),
            "c": torch.randn((5, 7), generator=gen).to(cuda)}
    weights = torch.rand((33, 5), generator=gen).to(cuda)
    before = kernels.LAUNCHES["weighted_avg"]
    got = weighted_avg(tree, weights)
    assert kernels.LAUNCHES["weighted_avg"] == before + 2
    for name, x in tree.items():
        flat = x.reshape(5, -1)
        want = weighted_avg_ref(flat, weights.to(x.dtype)).reshape(
            (33,) + x.shape[1:])
        _assert_wavg_close(got[name], want)


def test_quant8_codec_on_the_card_equals_the_cpu(cuda):
    """The per-leaf quant8 scale divides by 127 as a tensor: PyTorch on CUDA
    would multiply by the reciprocal of a CPU-scalar divisor instead, and
    x * fl(1/127) differs from x / 127 in the last bit for some x."""
    from repro_torch.federated.compression import _quant8
    gen = torch.Generator().manual_seed(0)
    for _ in range(200):
        x = torch.randn((64,), generator=gen) * float(
            torch.rand((), generator=gen)) * 10
        q_gpu, s_gpu = _quant8(x.to(cuda))
        q_cpu, s_cpu = _quant8(x)
        assert torch.equal(s_gpu.cpu().view(torch.int32),
                           s_cpu.view(torch.int32))
        assert torch.equal(q_gpu.cpu(), q_cpu)


@pytest.mark.parametrize("over", [
    {"shapley_impl": "batched"},
    {"straggler_frac": 0.5, "privacy_sigma": 0.05},
    {"selector": "power_of_choice"},
    {"upload_codec": "topk"}, {"upload_codec": "quant8_topk"}])
def test_small_batched_run_on_the_card_matches_the_cpu(cuda, over):
    """The default draws do not depend on the device, so the card's batched
    run must make the CPU's choices, with the sparse codecs too: equal
    selections, byte counts and dispatches, params and SVs at 1e-4."""
    from repro_torch.federated.client import ClientConfig
    from repro_torch.federated.server import FLConfig, run_federated
    from repro_torch.tree import tree_leaves
    cfg = FLConfig(**{**dict(n_clients=6, m=3, rounds=3, n_train=600,
                             n_val=100, n_test=100, eval_every=3,
                             shapley_max_iters=6, engine="batched",
                             client=ClientConfig(epochs=2,
                                                 batches_per_epoch=2,
                                                 batch_size=16)), **over})
    gpu, cpu = run_federated(cfg, device=cuda), run_federated(cfg,
                                                              device="cpu")
    for a, b in zip(gpu.selections, cpu.selections):
        np.testing.assert_array_equal(a, b)
    assert gpu.upload_bytes == cpu.upload_bytes
    assert gpu.shapley_evals == cpu.shapley_evals
    assert gpu.dispatches == cpu.dispatches
    np.testing.assert_allclose(gpu.sv_final, cpu.sv_final, atol=1e-4)
    for a, b in zip(tree_leaves(gpu.params), tree_leaves(cpu.params)):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), atol=1e-4)


@pytest.mark.parametrize("codec", ["quant8", "topk", "quant8_topk"])
def test_batched_engine_on_the_card_is_bitwise_the_loop_engine(cuda, codec):
    """Same device, same draws: the batched engine trains each client with
    the loop's own ops, and the codec kernel equals the per-client codec
    bitwise, so the two engines make the same run bit for bit."""
    import dataclasses
    from repro_torch.federated.client import ClientConfig
    from repro_torch.federated.server import FLConfig, run_federated
    from repro_torch.tree import tree_leaves
    cfg = FLConfig(n_clients=6, m=3, rounds=3, n_train=600, n_val=100,
                   n_test=100, eval_every=3, shapley_max_iters=6,
                   upload_codec=codec, straggler_frac=0.5,
                   client=ClientConfig(epochs=2, batches_per_epoch=2,
                                       batch_size=16))
    loop = run_federated(cfg, device=cuda)
    fused = run_federated(dataclasses.replace(cfg, engine="batched"),
                          device=cuda)
    for a, b in zip(fused.selections, loop.selections):
        np.testing.assert_array_equal(a, b)
    assert fused.upload_bytes == loop.upload_bytes
    np.testing.assert_array_equal(fused.sv_final, loop.sv_final)
    for a, b in zip(tree_leaves(fused.params), tree_leaves(loop.params)):
        assert torch.equal(a, b)


def test_batched_path_runs_through_all_five_kernels(cuda):
    """The batched engine with a codec (streaming SV), then with the dense
    oracle: every kernel of the slice launches, as often as the path
    says."""
    from repro_torch.federated.client import ClientConfig
    from repro_torch.federated.server import FLConfig, run_federated
    base = dict(n_clients=6, m=3, rounds=3, n_train=600, n_val=100,
                n_test=100, eval_every=3, shapley_max_iters=6,
                engine="batched", client=ClientConfig(epochs=1,
                                                      batches_per_epoch=2,
                                                      batch_size=16))
    kernels.reset_launches()
    res = run_federated(FLConfig(upload_codec="quant8_topk", **base))
    streaming = dict(kernels.LAUNCHES)
    kernels.reset_launches()
    dense = run_federated(FLConfig(shapley_impl="batched", **base))
    valued = [(r.shapley_evals - 2 * 3) // (6 * 3) for r in (res, dense)]
    assert min(valued) > 0
    # one cohort_gather a round (four stacks), one delta_codec a round (six
    # leaves), one prefix_avg a valued streaming round (six leaves) and one
    # weighted_avg a valued dense round (six leaves)
    assert streaming == {"prefix_avg": valued[0], "ce_loss": valued[0],
                         "cohort_gather": 3, "cohort_gather_shard": 0,
                         "delta_codec": 3, "weighted_avg": 0,
                         "flash_attention": 0, "flash_attention_bwd": 0,
                         "flash_attention_wide": 0,
                         "flash_attention_wide_bwd": 0}
    assert kernels.LAUNCHES == {"prefix_avg": 0, "ce_loss": valued[1],
                                "cohort_gather": 3, "cohort_gather_shard": 0,
                                "delta_codec": 0,
                                "weighted_avg": valued[1],
                                "flash_attention": 0,
                                "flash_attention_bwd": 0,
                                "flash_attention_wide": 0,
                                "flash_attention_wide_bwd": 0}


# ------------------------------------------------------ flash_attention ---
def _attn_inputs(seed, b, s, t, hq, kh, hd, dtype, device):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=gen).to(device, dtype)
            for shape in ((b, s, hq, hd), (b, t, kh, hd), (b, t, kh, hd))]


def _assert_bf16_attention_close(got, want):
    got, want = got.cpu().float(), want.float()
    torch.testing.assert_close(got, want, atol=3e-2, rtol=0)
    torch.testing.assert_close(got, want, atol=5e-3, rtol=1e-2)
    assert float((got - want).abs().mean()) <= 5e-3 * float(want.abs().mean())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,hq,kh,hd,win", [
    (2, 256, 8, 2, 64, 0), (2, 256, 8, 2, 64, 64), (1, 1000, 8, 2, 120, 128),
    (1, 1000, 8, 2, 120, 0), (2, 300, 4, 4, 128, 100),
    (1, 130, 4, 1, 128, 0), (1, 257, 2, 1, 32, 4096),
    (1, 64, 4, 2, 120, 1), (1, 1300, 25, 5, 64, 1024)])
def test_flash_attention_kernel_matches_plain(cuda, b, s, hq, kh, hd, win,
                                              dtype):
    """GQA G = 1..5 (G = 5: Hymba-1.5B's 25 query heads over 5 KV heads, hd
    64, window 1024), hd 32/64/120/128, ragged S, windows narrower and
    wider than a tile, against the plain version on the same inputs."""
    from repro_torch.kernels.flash_attention import flash_attention_gqa
    q, k, v = _attn_inputs(s + hd + win, b, s, s, hq, kh, hd, dtype, cuda)
    before = kernels.LAUNCHES["flash_attention"]
    got = flash_attention_gqa(q, k, v, window=win)
    assert kernels.LAUNCHES["flash_attention"] == before + 1
    want = flash_attention_gqa(q.cpu(), k.cpu(), v.cpu(), window=win)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (b, s, hq, hd)
    if dtype == torch.bfloat16:
        _assert_bf16_attention_close(got, want)
    else:
        torch.testing.assert_close(got.cpu(), want, atol=2e-5, rtol=0)


@pytest.mark.parametrize("hd", [32, 64, 72, 120, 128])
@pytest.mark.parametrize("s,win", [(200, 0), (333, 1), (1000, 128)])
def test_flash_attention_bf16_tensor_cores_match_plain(cuda, hd, s, win):
    """The bf16 route (wgmma, TMA) at head dims that pad to 64 or 128
    columns, S a multiple of neither tile (64 keys, 128 query rows),
    window 1, and window 128, where the rows 128..191 of a block find
    their first key tile (0..63) fully masked."""
    from repro_torch.kernels.flash_attention import flash_attention_gqa
    q, k, v = _attn_inputs(hd + s + win, 2, s, s, 4, 2, hd, torch.bfloat16,
                           cuda)
    before = kernels.LAUNCHES["flash_attention"]
    got = flash_attention_gqa(q, k, v, window=win)
    assert kernels.LAUNCHES["flash_attention"] == before + 1
    want = flash_attention_gqa(q.cpu(), k.cpu(), v.cpu(), window=win)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    _assert_bf16_attention_close(got, want)


def test_flash_attention_bf16_positions_not_from_zero(cuda):
    """Query positions 300..399 of 400 keys (a query tile that starts
    mid-sequence), causal with windows 0 and 256, and non-causal."""
    from repro_torch.kernels.flash_attention import flash_attention_gqa
    q, _, _ = _attn_inputs(11, 2, 100, 100, 8, 2, 120, torch.bfloat16, "cpu")
    _, k, v = _attn_inputs(12, 2, 400, 400, 8, 2, 120, torch.bfloat16, "cpu")
    pos = torch.arange(300, 400)
    for causal, win in ((True, 0), (True, 256), (False, 0)):
        got = flash_attention_gqa(q.to(cuda), k.to(cuda), v.to(cuda),
                                  q_pos=pos.to(cuda), causal=causal,
                                  window=win)
        want = flash_attention_gqa(q, k, v, q_pos=pos, causal=causal,
                                   window=win)
        _assert_bf16_attention_close(got, want)


def test_flash_attention_bf16_copies_views_tma_cannot_read(cuda):
    """q with rows of 121 elements (a stride of 242 bytes) and k starting
    one element into its buffer: the wrapper copies both into padded
    tensors and launches the same kernel once; v is read in place."""
    from repro_torch.kernels.flash_attention import flash_attention_gqa
    from repro_torch.kernels.flash_attention.kernel import tma_ready
    gen = torch.Generator().manual_seed(13)
    q = torch.randn((2, 150, 4, 121), generator=gen)[..., :120]
    k = torch.randn((2, 150, 2, 121), generator=gen)[..., 1:]
    v = torch.randn((2, 150, 2, 120), generator=gen)
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    vc = v.to(cuda)
    qc = torch.empty((2, 150, 4, 121), dtype=torch.bfloat16,
                     device=cuda)[..., :120].copy_(q)
    kc = torch.empty((2, 150, 2, 121), dtype=torch.bfloat16,
                     device=cuda)[..., 1:].copy_(k)
    assert not tma_ready(qc) and not tma_ready(kc) and tma_ready(vc)
    before = kernels.LAUNCHES["flash_attention"]
    got = flash_attention_gqa(qc, kc, vc, window=64)
    assert kernels.LAUNCHES["flash_attention"] == before + 1
    want = flash_attention_gqa(q, k, v, window=64)
    _assert_bf16_attention_close(got, want)


@pytest.mark.parametrize("hd", [32, 64, 72, 120, 128])
@pytest.mark.parametrize("s,win", [(200, 0), (333, 1), (1000, 128),
                                   (1000, 40)])
def test_flash_attention_f32_tensor_cores_match_plain(cuda, hd, s, win):
    """The f32 route (split-TF32 wgmma, TMA) at head dims that pad to 64 or
    128 columns (72: a 32-column chunk wholly past hd), S a multiple of
    neither tile (32 keys, 128 query rows), window 1, and windows 128 and
    40, where the last rows of a warpgroup find the first key tile of its
    band fully masked."""
    from repro_torch.kernels.flash_attention import flash_attention_gqa
    q, k, v = _attn_inputs(hd + s + win, 2, s, s, 4, 2, hd, torch.float32,
                           cuda)
    before = kernels.LAUNCHES["flash_attention"]
    got = flash_attention_gqa(q, k, v, window=win)
    assert kernels.LAUNCHES["flash_attention"] == before + 1
    want = flash_attention_gqa(q.cpu(), k.cpu(), v.cpu(), window=win)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == q.shape
    torch.testing.assert_close(got.cpu(), want, atol=2e-5, rtol=0)


def test_flash_attention_f32_positions_not_from_zero(cuda):
    """Query positions 300..399 of 400 keys (a query tile that starts
    mid-sequence), causal with windows 0 and 256, and non-causal."""
    from repro_torch.kernels.flash_attention import flash_attention_gqa
    q, _, _ = _attn_inputs(11, 2, 100, 100, 8, 2, 120, torch.float32, "cpu")
    _, k, v = _attn_inputs(12, 2, 400, 400, 8, 2, 120, torch.float32, "cpu")
    pos = torch.arange(300, 400)
    for causal, win in ((True, 0), (True, 256), (False, 0)):
        got = flash_attention_gqa(q.to(cuda), k.to(cuda), v.to(cuda),
                                  q_pos=pos.to(cuda), causal=causal,
                                  window=win)
        want = flash_attention_gqa(q, k, v, q_pos=pos, causal=causal,
                                   window=win)
        torch.testing.assert_close(got.cpu(), want, atol=2e-5, rtol=0)


def test_flash_attention_f32_copies_views_tma_cannot_read(cuda):
    """q with rows of 121 floats (a stride of 484 bytes) and k starting one
    element into its buffer: the wrapper copies both into padded tensors
    and launches the same kernel once; v is read in place."""
    from repro_torch.kernels.flash_attention import flash_attention_gqa
    from repro_torch.kernels.flash_attention.kernel import tma_ready
    gen = torch.Generator().manual_seed(14)
    q = torch.randn((2, 150, 4, 121), generator=gen)[..., :120]
    k = torch.randn((2, 150, 2, 121), generator=gen)[..., 1:]
    v = torch.randn((2, 150, 2, 120), generator=gen)
    vc = v.to(cuda)
    qc = torch.empty((2, 150, 4, 121), device=cuda)[..., :120].copy_(q)
    kc = torch.empty((2, 150, 2, 121), device=cuda)[..., 1:].copy_(k)
    assert not tma_ready(qc) and not tma_ready(kc) and tma_ready(vc)
    before = kernels.LAUNCHES["flash_attention"]
    got = flash_attention_gqa(qc, kc, vc, window=64)
    assert kernels.LAUNCHES["flash_attention"] == before + 1
    want = flash_attention_gqa(q, k, v, window=64)
    torch.testing.assert_close(got.cpu(), want, atol=2e-5, rtol=0)


@pytest.mark.parametrize("s,hd,win", [(256, 120, 0), (200, 128, 128)])
def test_flash_attention_f32_large_scores(cuda, s, hd, win):
    """q and k scaled alike so that the largest |score| is 30, where the
    softmax is sharpest and an error in S shows most in the output."""
    from repro_torch.kernels.flash_attention import flash_attention_gqa
    q, k, v = _attn_inputs(s + hd, 1, s, s, 4, 2, hd, torch.float32, "cpu")
    kr = k.repeat_interleave(2, dim=2)
    s0 = float(torch.einsum("bqhd,bkhd->bhqk", q, kr).abs().max()) * hd ** -0.5
    c = (30.0 / s0) ** 0.5
    q, k = q * c, k * c
    got = flash_attention_gqa(q.to(cuda), k.to(cuda), v.to(cuda), window=win)
    want = flash_attention_gqa(q, k, v, window=win)
    torch.testing.assert_close(got.cpu(), want, atol=2e-5, rtol=0)


def test_flash_attention_f32_ignores_the_tf32_switch(cuda):
    """The split is the kernel's own: allowing TF32 matmuls in PyTorch does
    not change a bit of the f32 route's output."""
    from repro_torch.kernels.flash_attention import flash_attention_gqa
    q, k, v = _attn_inputs(21, 2, 300, 300, 8, 2, 120, torch.float32, cuda)
    saved = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        off = flash_attention_gqa(q, k, v, window=100)
        torch.backends.cuda.matmul.allow_tf32 = True
        on = flash_attention_gqa(q, k, v, window=100)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    assert torch.equal(off, on)


def test_flash_attention_kernel_reads_strided_views_and_positions(cuda):
    """q as a column slice, k/v as (B, Kh, T, hd) transposed views, query
    positions 40..79 of 80 keys, causal and not."""
    from repro_torch.kernels.flash_attention import flash_attention_gqa
    gen = torch.Generator().manual_seed(5)
    wide = torch.randn((2, 40, 4, 2 * 120), generator=gen)
    k = torch.randn((2, 2, 80, 120), generator=gen).transpose(1, 2)
    v = torch.randn((2, 2, 80, 120), generator=gen).transpose(1, 2)
    q = wide[..., :120]
    pos = torch.arange(40, 80)
    for causal, win in ((True, 0), (True, 24), (False, 0), (False, 24)):
        got = flash_attention_gqa(q.to(cuda), k.to(cuda), v.to(cuda),
                                  q_pos=pos.to(cuda), causal=causal,
                                  window=win)
        want = flash_attention_gqa(q, k, v, q_pos=pos, causal=causal,
                                   window=win)
        torch.testing.assert_close(got.cpu(), want, atol=2e-5, rtol=0)


def test_flash_attention_bh_contract_on_the_card(cuda):
    from repro_torch.kernels.flash_attention import (
        attention_ref, flash_attention,
    )
    gen = torch.Generator().manual_seed(6)
    q, k, v = (torch.randn((6, 200, 64), generator=gen) for _ in range(3))
    before = kernels.LAUNCHES["flash_attention"]
    got = flash_attention(q.to(cuda), k.to(cuda), v.to(cuda), window=50)
    assert kernels.LAUNCHES["flash_attention"] == before + 1
    torch.testing.assert_close(got.cpu(), attention_ref(q, k, v, window=50),
                               atol=2e-5, rtol=0)


def test_flash_attention_cuda_route_raises_instead_of_falling_back(cuda):
    from repro_torch.kernels.flash_attention import flash_attention_gqa
    q, k, v = _attn_inputs(0, 1, 64, 64, 4, 2, 64, torch.float32, cuda)
    before = kernels.LAUNCHES["flash_attention"]
    bad = [((q.half(), k.half(), v.half()), TypeError),
           ((q, k.double(), v), TypeError),
           ((q, k.cpu(), v), ValueError),
           ((q[:, :, :3], k, v), ValueError),
           ((q, k.transpose(-1, -2).contiguous().transpose(-1, -2), v),
            ValueError)]
    for args, err in bad:
        with pytest.raises(err):
            flash_attention_gqa(*args)
    assert kernels.LAUNCHES["flash_attention"] == before


@pytest.mark.parametrize("s", [256, 200])
def test_model_flash_branch_runs_the_kernel(cuda, s):
    """attention(impl="flash") on the card launches the kernel once and
    matches the plain blocked loop of the CPU route, also where T is not a
    multiple of kv_chunk (both drop the keys past the last whole block,
    as the reference's scan does)."""
    from repro_torch.models.lm.attention import attention
    q, k, v = _attn_inputs(7, 2, s, s, 8, 2, 120, torch.float32, "cpu")
    pos = torch.arange(s)
    want = attention(q, k, v, q_pos=pos, window=96, impl="flash",
                     kv_chunk=64)
    before = kernels.LAUNCHES["flash_attention"]
    got = attention(q.to(cuda), k.to(cuda), v.to(cuda), q_pos=pos.to(cuda),
                    window=96, impl="flash", kv_chunk=64)
    assert kernels.LAUNCHES["flash_attention"] == before + 1
    torch.testing.assert_close(got.cpu(), want, atol=2e-5, rtol=0)


# ------------------------------------------------ flash_attention_bwd ---
def _bwd_case(seed, b, s, t, hq, kh, hd, dtype, device, pos=None,
              causal=True, window=0):
    """Inputs, the forward kernel's o and lse, and an upstream gradient."""
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_cuda,
    )
    q, k, v = _attn_inputs(seed, b, s, t, hq, kh, hd, dtype, device)
    o, lse = flash_attention_cuda(q, k, v, pos, causal=causal,
                                  window=window, with_lse=True)
    do = torch.randn(o.shape, generator=torch.Generator().manual_seed(
        seed + 1)).to(device, dtype)
    return q, k, v, o, do, lse


def assert_bwd_close(got, want, dtype, vanish=(), slack=None):
    """The backward's tolerance, element by element: |got - want| <= rtol
    |want| + 2e-5 max |want|, a tensor at a time.  f32: rtol 0, the
    forward's 2e-5 of the largest gradient.  bf16, against the plain
    version of its arithmetic (`attention_bwd_bf16_ref`, in f32, of the
    same bf16 inputs): the kernel rounds each output once to bf16 (at most
    2^-8 of the value), so rtol 2^-7; and where its f32 P or dS and the
    plain version's lie on either side of a bf16 tie, the two round them
    apart, which `slack` (`attention_bwd_bf16_slack`, per element) adds to
    the limit.  A tensor named in `vanish` is zero in exact arithmetic and
    both sides hold only rounding noise: it is held at 2e-5 of max |dv|
    instead."""
    rtol = 0.0 if dtype == torch.float32 else 2.0 ** -7
    dv_top = float(want[2].float().abs().max())
    for i, (name, g, w) in enumerate(zip(("dq", "dk", "dv"), got, want)):
        g, w = g.cpu().float(), w.float()
        top = dv_top if name in vanish else float(w.abs().max())
        limit = rtol * w.abs() + 2e-5 * top
        if slack is not None:
            limit = limit + slack[i].float()
        bad = ~((g - w).abs() <= limit)          # a NaN is over its limit
        # the first bad elements' (b, s, h, d): one row or tile, or spread
        assert not bool(bad.any()), (name, int(bad.sum()),
                                     float((g - w).abs().max()), top,
                                     bad.nonzero()[:8].tolist())


def assert_bwd_departure(got, want, vanish=()):
    """The bf16 kernel against the exact float32 plain version: P and dS
    are rounded to bf16 before the products that read them, a relative
    error of at most 2^-9 in each term of a sum, so a gradient departs by
    at most 2^-9 of its terms' absolute sum; with random-sign terms that is
    ~1.7e-3 of the gradient's size (the bf16-rounding plain version
    against the exact one on the CPU: 1.60-1.67e-3 in the mean, at most
    2.2e-3 of max |grad|, at S = 300 and 2048).  Held at twice that, 2^-8:
    per element |err| <= 2^-7 |want| (the output's own bf16 rounding) +
    2^-8 max |want|, and mean |err| <= 2^-8 mean |want|.  A tensor named
    in `vanish` is rounding noise on both sides (see `assert_bwd_close`):
    held at 2^-8 of max |dv|, with no mean rule."""
    dv_top = float(want[2].float().abs().max())
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        g, w = g.cpu().float(), w.float()
        err = (g - w).abs()
        top = dv_top if name in vanish else float(w.abs().max())
        bad = ~(err <= 2.0 ** -7 * w.abs() + 2.0 ** -8 * top)
        assert not bool(bad.any()), (name, int(bad.sum()),
                                     float(err.max()), top)
        if name not in vanish:
            assert float(err.mean()) <= 2.0 ** -8 * float(w.abs().mean()), (
                name, float(err.mean()), float(w.abs().mean()))


def _check_bwd(cuda, dtype, q, k, v, o, do, lse, pos, causal, win):
    """Two launches bitwise equal and counted; f32 against the plain
    version at `assert_bwd_close`; bf16 against the bf16-rounding plain
    version at `assert_bwd_close` with its flip slack, and against the
    exact one at `assert_bwd_departure`."""
    from repro_torch.kernels.flash_attention import (
        attention_bwd_bf16_ref, attention_bwd_bf16_slack,
        attention_bwd_gqa_ref,
    )
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_bwd_cuda,
    )
    before = kernels.LAUNCHES["flash_attention_bwd"]
    got = flash_attention_bwd_cuda(q, k, v, o, do, lse, pos, causal=causal,
                                   window=win)
    again = flash_attention_bwd_cuda(q, k, v, o, do, lse, pos,
                                     causal=causal, window=win)
    assert kernels.LAUNCHES["flash_attention_bwd"] == before + 2
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    assert [x.dtype for x in got] == [dtype] * 3
    assert [x.shape for x in got] == [q.shape, k.shape, v.shape]
    args = (*(x.cpu().float() for x in (q, k, v, o, do)), lse.cpu())
    kw = {"q_pos": pos.cpu(), "causal": causal, "window": win}
    exact = attention_bwd_gqa_ref(*args, **kw)
    # window 1, or a single key: each query sees only one key, so dS =
    # P (dO.v - dO.o) is 0 and dq, dk with it
    vanish = ("dq", "dk") if win == 1 or k.shape[1] == 1 else ()
    if dtype == torch.float32:
        assert_bwd_close(got, exact, dtype, vanish)
        return
    assert_bwd_close(
        got, attention_bwd_gqa_ref(*args, **kw, plain=attention_bwd_bf16_ref),
        dtype, vanish,
        attention_bwd_gqa_ref(*args, **kw, plain=attention_bwd_bf16_slack))
    assert_bwd_departure(got, exact, vanish)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,t,hq,kh,hd,causal,win,off", [
    (2, 256, 256, 8, 2, 64, True, 0, 0), (1, 300, 300, 8, 2, 120, True, 96,
                                           0),
    (2, 200, 200, 4, 4, 128, False, 0, 0), (1, 130, 130, 4, 1, 32, True, 0,
                                            0),
    (1, 100, 400, 8, 2, 120, True, 256, 300),
    (1, 77, 333, 4, 2, 64, False, 50, 200), (2, 129, 129, 6, 3, 72, True, 1,
                                             0),
    (1, 1300, 1300, 25, 5, 64, True, 1024, 0)])
def test_flash_attention_bwd_kernel_matches_plain(cuda, dtype, b, s, t, hq,
                                                  kh, hd, causal, win, off):
    """dq / dk / dv against `attention_bwd_gqa_ref` on the same inputs, o
    and lse (bf16: also against its bf16-rounding arithmetic): GQA G =
    1..5 (G = 5 at Hymba-1.5B's heads, hd 64 and window 1024), hd 32..128,
    ragged S and T, windows, a q_pos offset and non-causal; two launches
    bitwise equal."""
    pos = torch.arange(off, off + s, device=cuda)
    q, k, v, o, do, lse = _bwd_case(s + t + hd, b, s, t, hq, kh, hd, dtype,
                                    cuda, pos, causal, win)
    _check_bwd(cuda, dtype, q, k, v, o, do, lse, pos, causal, win)


def _check_wide(cuda, dtype, q, k, v, pos, causal, win):
    """The wide route on (q, k, v): counted under its own name, forward
    against the plain version (f32 at 2e-5, bf16 at the bf16 bounds), its
    lse at 1e-4; the backward's two launches bitwise equal, f32 against
    the exact plain backward at `assert_bwd_close`; bf16 up to hd 256 (the
    tensor-core kernels: P and dS rounded to bf16, as the narrow route)
    held as `_check_bwd` holds the narrow bf16 backward, against
    `attention_bwd_bf16_ref` with its flip slack and against the exact
    backward at `assert_bwd_departure`; bf16 above 256 (the CUDA cores,
    which round only their outputs) against the exact backward at
    `assert_bwd_close`."""
    from repro_torch.kernels.flash_attention import (
        attention_bwd_bf16_ref, attention_bwd_bf16_slack,
        attention_bwd_gqa_ref, flash_attention_gqa,
    )
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_bwd_cuda, flash_attention_cuda, route,
    )
    from repro_torch.kernels.flash_attention.ops import _forward_ref
    hd = q.shape[3]
    assert route(dtype, hd) == ("tc_wide" if hd <= 256 else "cuda_cores")
    before = dict(kernels.LAUNCHES)
    got = flash_attention_gqa(q, k, v, q_pos=pos, causal=causal, window=win)
    o, lse = flash_attention_cuda(q, k, v, pos, causal=causal, window=win,
                                  with_lse=True)
    assert kernels.LAUNCHES["flash_attention_wide"] == \
        before["flash_attention_wide"] + 2
    assert kernels.LAUNCHES["flash_attention"] == before["flash_attention"]
    assert torch.equal(got, o)
    want = flash_attention_gqa(q.cpu(), k.cpu(), v.cpu(), q_pos=pos.cpu(),
                               causal=causal, window=win)
    if dtype == torch.float32:
        torch.testing.assert_close(got.cpu(), want, atol=2e-5, rtol=0)
    else:
        _assert_bf16_attention_close(got, want)
    _, lse_want = _forward_ref(*(x.cpu().float() for x in (q, k, v)),
                               pos.cpu(), causal, win, with_lse=True)
    torch.testing.assert_close(lse.cpu(), lse_want, atol=1e-4, rtol=0)

    gen = torch.Generator().manual_seed(hd)
    do = torch.randn(q.shape, generator=gen).to(cuda, dtype)
    grads = flash_attention_bwd_cuda(q, k, v, o, do, lse, pos, causal=causal,
                                     window=win)
    again = flash_attention_bwd_cuda(q, k, v, o, do, lse, pos, causal=causal,
                                     window=win)
    assert kernels.LAUNCHES["flash_attention_wide_bwd"] == \
        before["flash_attention_wide_bwd"] + 2
    assert kernels.LAUNCHES["flash_attention_bwd"] == \
        before["flash_attention_bwd"]
    assert all(torch.equal(x, y) for x, y in zip(grads, again))
    assert [x.dtype for x in grads] == [dtype] * 3
    args = (*(x.cpu().float() for x in (q, k, v, o, do)), lse.cpu())
    kw = {"q_pos": pos.cpu(), "causal": causal, "window": win}
    exact = attention_bwd_gqa_ref(*args, **kw)
    if dtype == torch.float32 or hd > 256:
        assert_bwd_close(grads, exact, dtype)
        return
    assert_bwd_close(
        grads, attention_bwd_gqa_ref(*args, **kw,
                                     plain=attention_bwd_bf16_ref),
        dtype, (), attention_bwd_gqa_ref(*args, **kw,
                                         plain=attention_bwd_bf16_slack))
    assert_bwd_departure(grads, exact)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,t,hq,kh,hd,win,causal,off", [
    (1, 2048, 2048, 4, 4, 256, 0, True, 0),   # the federated LM's layer
    (2, 300, 300, 4, 2, 256, 100, True, 0),
    (1, 130, 130, 6, 3, 160, 0, True, 0), (1, 77, 77, 2, 1, 384, 0, True, 0),
    # the tensor-core kernels' edges: hd padded to 256 from 136 and 200,
    # G = 5, S != T with a q_pos offset, non-causal, windows that cut their
    # 64-key (bf16) and 32- and 16-key (f32) tiles
    (1, 200, 200, 4, 2, 136, 0, True, 0),
    (1, 150, 150, 4, 2, 200, 0, True, 0),
    (1, 520, 520, 10, 2, 256, 128, True, 0),
    (2, 100, 356, 4, 2, 192, 0, True, 256),
    (1, 200, 333, 4, 4, 256, 0, False, 0),
    (1, 300, 300, 4, 2, 160, 40, True, 0),
    (1, 70, 300, 10, 2, 136, 90, True, 230),
    (1, 190, 190, 4, 2, 200, 70, False, 0)])
def test_flash_attention_wide_route_matches_plain(cuda, dtype, b, s, t, hq,
                                                  kh, hd, win, causal, off):
    """Head dims above 128 run the wide route, counted under its own name
    whichever kernel runs it (`kernel.py::route`): up to 256 on the tensor
    cores at hd padded to 256 (bf16 wgmma with P and dS rounded to bf16,
    f32 split-TF32 wgmma), wider on the CUDA cores (float32 throughout, the
    head dim in chunks of 128).  Each dtype's rules (`_check_wide`), two
    launches bitwise equal both ways."""
    q, k, v = _attn_inputs(s + hd + win, b, s, t, hq, kh, hd, dtype, cuda)
    pos = torch.arange(off, off + s, device=cuda)
    _check_wide(cuda, dtype, q, k, v, pos, causal, win)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_wide_route_copies_views_tma_cannot_read(cuda,
                                                                 dtype):
    """At hd 256, q, k and v as views whose strides are not multiples of 16
    bytes: the wrapper copies them for TMA (both directions), and the
    results hold each dtype's rules (`_check_wide`)."""
    from repro_torch.kernels.flash_attention.kernel import tma_ready
    q, k, v = (_padded_view(x) for x in
               _attn_inputs(41, 1, 190, 190, 6, 3, 256, dtype, cuda))
    assert not any(tma_ready(x) for x in (q, k, v))
    pos = torch.arange(190, device=cuda)
    _check_wide(cuda, dtype, q, k, v, pos, True, 70)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_on_local_heads_matches_whole_heads(cuda, dtype):
    """Hq 32 over Kh 8 split over a model axis of 16 (Danube and
    Mistral-NeMo at m = 16, where wq is head-sharded and wk / wv are
    replicated): each rank's 2 query heads with the one KV head
    `tp.kv_index` gives them (G' = 2, not the global G = 4) through the
    kernel equal the whole-head call's heads bitwise, forward and dq (each
    head is its own); the two ranks' dk / dv of a shared KV head sum to the
    whole call's (f32: 2e-5 of max |grad|; bf16: 2^-7 |grad| + 2^-8 max
    |grad|, each partial rounded once)."""
    from repro_torch.kernels.flash_attention import flash_attention_gqa
    from repro_torch.models.lm.tp import kv_index, take_heads
    q, k, v = (x.requires_grad_() for x in
               _attn_inputs(32, 2, 300, 300, 32, 8, 64, dtype, cuda))
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(1)
                     ).to(cuda, dtype)
    whole = flash_attention_gqa(q, k, v)
    dq, dk, dv = torch.autograd.grad(whole, (q, k, v), do)
    sum_k, sum_v = torch.zeros_like(dk), torch.zeros_like(dv)
    for r in range(16):
        heads, g = kv_index(2 * r, 2, 4)
        assert heads == (r // 2,) and g == 2
        ql = q[:, :, 2 * r:2 * r + 2].detach().requires_grad_()
        kl = take_heads(k, heads).detach().requires_grad_()
        vl = take_heads(v, heads).detach().requires_grad_()
        got = flash_attention_gqa(ql, kl, vl)
        assert torch.equal(got, whole[:, :, 2 * r:2 * r + 2])
        gq, gk, gv = torch.autograd.grad(got, (ql, kl, vl),
                                         do[:, :, 2 * r:2 * r + 2])
        assert torch.equal(gq, dq[:, :, 2 * r:2 * r + 2])
        sum_k[:, :, r // 2] += gk[:, :, 0].float().to(dtype)
        sum_v[:, :, r // 2] += gv[:, :, 0].float().to(dtype)
    rtol = 0.0 if dtype == torch.float32 else 2.0 ** -7
    top = 2e-5 if dtype == torch.float32 else 2.0 ** -8
    for got, want in ((sum_k, dk), (sum_v, dv)):
        got, want = got.float(), want.float()
        limit = rtol * want.abs() + top * want.abs().max()
        assert bool(((got - want).abs() <= limit).all())


def _padded_view(x):
    """x as a view of a wider tensor whose rows are 3 elements longer, so
    that its strides are not multiples of 16 bytes: TMA cannot read it."""
    wide = torch.zeros((*x.shape[:3], x.shape[3] + 3), dtype=x.dtype,
                       device=x.device)
    wide[..., :x.shape[3]] = x
    return wide[..., :x.shape[3]]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,t,hq,kh,hd,causal,win,off,view", [
    (1, 256, 256, 16, 2, 64, True, 0, 0, False),       # G = 8
    (2, 200, 200, 8, 1, 128, True, 0, 0, False),       # G = 8, hd 128
    (1, 190, 190, 4, 2, 32, True, 0, 0, False),        # hd 32
    (1, 150, 150, 4, 2, 72, True, 40, 0, False),       # hd 72, a window
    (1, 333, 333, 8, 8, 120, True, 100, 0, False),     # hd 120, G = 1
    (1, 1, 1, 4, 2, 64, True, 0, 0, False),            # S = T = 1
    (1, 1, 700, 8, 2, 64, True, 0, 699, False),        # S = 1, T >> S
    (2, 70, 1000, 8, 2, 128, True, 0, 930, False),     # T >> S, q_pos
    (1, 97, 97, 4, 1, 64, True, 1, 0, False),          # window 1
    (1, 130, 260, 4, 2, 64, False, 0, 0, False),       # non-causal
    (1, 120, 120, 8, 2, 64, False, 30, 0, False),      # non-causal window
    (1, 129, 129, 6, 3, 72, True, 0, 0, True),         # views to copy
    (2, 100, 100, 4, 2, 60, True, 0, 0, False)])       # hd 60: copied
def test_flash_attention_bwd_tensor_core_route(cuda, dtype, b, s, t, hq, kh,
                                               hd, causal, win, off, view):
    """Both routes' tensor-core kernels (bf16 wgmma; f32 split-TF32 wgmma)
    at G = 8, hd 32 / 60 / 64 / 72 / 120 / 128, S and T off the 32-, 64-
    and 128-row tiles, S = 1, T much longer than S, window 1, a q_pos
    offset, non-causal, and views that TMA cannot read (copied by the
    wrapper): each dtype's rules (`_check_bwd`), two launches bitwise
    equal."""
    from repro_torch.kernels.flash_attention.kernel import tma_ready
    pos = torch.arange(off, off + s, device=cuda)
    q, k, v, o, do, lse = _bwd_case(7 * s + t + hd, b, s, t, hq, kh, hd,
                                    dtype, cuda, pos, causal, win)
    if view:
        q, k, v, o, do = (_padded_view(x) for x in (q, k, v, o, do))
        assert not any(tma_ready(x) for x in (q, k, v, o, do))
    _check_bwd(cuda, dtype, q, k, v, o, do, lse, pos, causal, win)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_forward_lse_is_bitwise_neutral_and_the_plain_lse(cuda,
                                                                 dtype):
    """The forward's output with its lse is bitwise the output without it,
    and the lse is the plain log-sum-exp (f32 at 1e-4 on values ~ 5)."""
    from repro_torch.kernels.flash_attention import attention_ref
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_cuda,
    )
    q, k, v = _attn_inputs(21, 2, 333, 333, 8, 2, 120, dtype, cuda)
    for win in (0, 100):
        plain = flash_attention_cuda(q, k, v, window=win)
        o, lse = flash_attention_cuda(q, k, v, window=win, with_lse=True)
        assert torch.equal(o, plain)
        g = q.shape[2] // k.shape[2]
        _, want = attention_ref(
            q.cpu().float().transpose(1, 2).flatten(0, 1),
            k.cpu().float().transpose(1, 2).flatten(0, 1).repeat_interleave(
                g, 0),
            v.cpu().float().transpose(1, 2).flatten(0, 1).repeat_interleave(
                g, 0), window=win, with_lse=True)
        torch.testing.assert_close(lse.cpu().flatten(0, 1), want, atol=1e-4,
                                   rtol=0)


def test_flash_attention_fn_on_the_card_matches_the_cpu(cuda):
    """Autograd through `flash_attention_gqa` on the card (the forward
    with lse, then the backward kernel) against the CPU route's."""
    from repro_torch.kernels.flash_attention import flash_attention_gqa
    q, k, v = _attn_inputs(31, 2, 200, 200, 8, 2, 64, torch.float32, "cpu")
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(32))
    grads = []
    for dev in ("cpu", cuda):
        xs = [x.to(dev).requires_grad_() for x in (q, k, v)]
        out = flash_attention_gqa(*xs, window=64)
        grads.append(torch.autograd.grad(out, xs, g.to(dev)))
    assert_bwd_close(grads[1], grads[0], torch.float32)


def _train_cfg():
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config("tinyllama_1_1b").reduced(n_layers=2)
    return dataclasses.replace(cfg, attn_impl="flash", attn_chunk=32,
                               remat=True)


def test_train_step_on_the_card_matches_the_cpu(cuda):
    """Two AdamW train steps of a reduced TinyLlama (flash branch at S =
    128, per-layer remat) on the card with the CPU run's weights: losses
    at 1e-4 relative, AdamW's moments at 5e-5 of a leaf's max, params at
    1e-5 but where a gradient is ~0 (below);
    flash_attention launches twice a layer a step (the forward, and
    remat's recompute), the backward once."""
    from repro_torch.interop import params_from_numpy, params_to_numpy
    from repro_torch.models.lm import model as M
    from repro_torch.tree import tree_leaves
    cfg = _train_cfg()
    cpu_params = M.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 128),
                           generator=torch.Generator().manual_seed(1))
    opt_init, step = M.make_train_step(cfg)
    runs = []
    for dev in ("cpu", cuda):
        p = params_from_numpy(params_to_numpy(cpu_params), device=dev)
        opt, losses = opt_init(p), []
        kernels.reset_launches()
        for _ in range(2):
            p, opt, m = step(p, opt, {"tokens": tokens.to(dev)})
            losses.append(float(m["loss"]))
        runs.append((p, opt, losses, dict(kernels.LAUNCHES)))
    (pc, oc, lc, nc), (pg, og, lg, ng) = runs
    assert nc["flash_attention"] == 0 and nc["flash_attention_bwd"] == 0
    assert ng["flash_attention"] == 2 * 2 * cfg.n_layers
    assert ng["flash_attention_bwd"] == 2 * cfg.n_layers
    np.testing.assert_allclose(lg, lc, rtol=1e-4)
    # the gradients, through AdamW's moments, agree everywhere
    for a, b in zip(tree_leaves(og.mu) + tree_leaves(og.nu),
                    tree_leaves(oc.mu) + tree_leaves(oc.nu)):
        assert float((a.cpu() - b).abs().max()) <= 5e-5 * float(
            b.abs().max())
    # AdamW's m / sqrt(v) turns a last-bit difference of a gradient that
    # is ~0 into up to a step of the other sign: all but 1e-3 of each leaf
    # at 1e-5
    for a, b in zip(tree_leaves(pg), tree_leaves(pc)):
        err = (a.cpu() - b).abs()
        assert float((err > 1e-5).float().mean()) <= 1e-3


def _served_cfg():
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config("h2o_danube_3_4b").reduced(n_layers=2)
    return dataclasses.replace(cfg, attn_impl="flash", attn_chunk=32)


def test_serve_on_the_card_matches_the_cpu(cuda):
    """A reduced H2O-Danube-3 (flash prefill, 64-slot window ring) served
    on the card with the CPU run's weights: the same tokens, log-prob sums
    and request SVs; prefill launches the kernel once per layer, decode
    never."""
    from repro_torch.interop import params_from_numpy, params_to_numpy
    from repro_torch.models.lm import model as M
    from repro_torch.serve import serve_requests
    cfg = _served_cfg()
    cpu_params = M.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    tokens = torch.randint(0, cfg.vocab, (4, 128),
                           generator=torch.Generator().manual_seed(1))
    want = serve_requests(cfg, cpu_params, tokens, 6, device="cpu")
    kernels.reset_launches()
    got = serve_requests(cfg, params_from_numpy(params_to_numpy(cpu_params),
                                                device=cuda), tokens, 6)
    assert kernels.LAUNCHES["flash_attention"] == cfg.n_layers
    assert torch.equal(got.generated.cpu(), want.generated)
    torch.testing.assert_close(got.logprob_sum.cpu(), want.logprob_sum,
                               atol=1e-4, rtol=0)
    torch.testing.assert_close(got.sv.cpu(), want.sv, atol=1e-4, rtol=0)


def test_decode_on_the_card_matches_forward(cuda):
    import dataclasses
    from repro_torch.models.lm import model as M
    cfg = _served_cfg()
    params = M.init_params(cfg, torch.Generator(device=cuda).manual_seed(2))
    tokens = torch.randint(0, cfg.vocab, (2, 131), device=cuda,
                           generator=torch.Generator(device=cuda
                                                     ).manual_seed(3))
    cache, lg = M.prefill_step(cfg, params, {"tokens": tokens[:, :128]},
                               cache_len=136)
    dense = dataclasses.replace(cfg, attn_impl="dense")
    for i in range(3):
        full, _ = M.forward(dense, params, {"tokens": tokens[:, :128 + i]})
        torch.testing.assert_close(lg, full[:, -1], atol=2e-3, rtol=2e-3)
        cache, lg = M.decode_step(cfg, params, cache,
                                  {"token": tokens[:, 128 + i]})


def _family_cfg(arch, **over):
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch).reduced(n_layers=2), **over)


@pytest.mark.parametrize("dtype,cf", [("float32", 1.0), ("bfloat16", 8.0)])
def test_moe_on_the_card_matches_the_cpu_and_repeats_bitwise(cuda, dtype, cf):
    """`moe_apply` (32 experts, top-8) on the card against the CPU with the
    same weights, two calls on the card bitwise equal (the combine sums
    each token's kept contributions in a fixed order, no atomics).  f32 at
    capacity factor 1.0 (drops happen): the same routing tables, outputs
    at 1e-5, aux at 1e-6.  bf16 at 8 (no drops): a token may route
    differently only where its k-th and (k+1)-th probabilities lie within
    one bf16 ulp; the others' outputs at the bf16 model bound 0.1."""
    from repro_torch.models.lm import moe
    cfg = _family_cfg("qwen3_moe_30b_a3b", n_experts=32, top_k=8,
                      capacity_factor=cf, dtype=dtype)
    gen = torch.Generator().manual_seed(40)
    p = moe.moe_init(gen, cfg)
    x = torch.randn((2, 96, cfg.d_model), generator=gen).to(
        getattr(torch, dtype))
    pc = {k: v.to(cuda) for k, v in p.items()}
    want, want_aux = moe.moe_apply(p, cfg, x, n_groups=2)
    got, aux = moe.moe_apply(pc, cfg, x.to(cuda), n_groups=2)
    again, aux2 = moe.moe_apply(pc, cfg, x.to(cuda), n_groups=2)
    assert torch.equal(got, again) and torch.equal(aux, aux2)
    xg = x.reshape(2, -1, cfg.d_model)
    r_cpu, r_gpu = moe.moe_route(p, cfg, xg), moe.moe_route(pc, cfg,
                                                           xg.to(cuda))
    if dtype == "float32":
        assert all(torch.equal(a.cpu(), b) for a, b in zip(r_gpu[:2],
                                                           r_cpu[:2]))
        assert float(r_cpu[1].sum()) < 2 * 96 * cfg.top_k  # drops happen
        torch.testing.assert_close(got.cpu(), want, atol=1e-5, rtol=0)
        torch.testing.assert_close(aux.cpu(), want_aux, atol=1e-6, rtol=0)
        return
    # bf16: the tokens whose top-k sets differ
    sets = [r[3].cpu().reshape(-1, cfg.top_k).sort(-1).values
            for r in (r_cpu, r_gpu)]
    moved = (sets[0] != sets[1]).any(-1)
    probs = moe._router(p, cfg, x.reshape(-1, cfg.d_model))[0]
    srt = probs.sort(-1, descending=True).values
    gap = srt[:, cfg.top_k - 1] - srt[:, cfg.top_k]
    ulp = 2.0 ** (torch.floor(torch.log2(srt[:, cfg.top_k - 1])) - 7)
    print(f"bf16 MoE on the card: {int(moved.sum())} of {len(moved)} "
          f"tokens routed differently")
    assert bool((gap[moved] <= ulp[moved]).all())
    err = (got.cpu().float() - want.float()).reshape(-1, cfg.d_model)
    assert float(err[~moved].abs().max()) <= 0.1


@pytest.mark.parametrize("arch", ["mamba2_370m", "hymba_1_5b"])
def test_ssm_on_the_card_matches_the_cpu(cuda, arch):
    """`ssm_forward` (S = 256, four 64-token chunks), the prefill's final
    state and 4 `ssm_decode_step`s on the card against the CPU with the
    same weights, f32 at 1e-4 (products in another order)."""
    from repro_torch.models.lm import ssm
    cfg = _family_cfg(arch, dtype="float32")
    gen = torch.Generator().manual_seed(41)
    p = ssm.ssm_init(gen, cfg)
    pc = {k: (v.to(cuda) if isinstance(v, torch.Tensor) else
              {kk: vv.to(cuda) for kk, vv in v.items()})
          for k, v in p.items()}
    x = torch.randn((2, 260, cfg.d_model), generator=gen)
    outs = []
    for dev, pp in (("cpu", p), (cuda, pc)):
        xs = x.to(dev)
        y, state = ssm.ssm_forward(pp, cfg, xs[:, :256], with_state=True)
        cache = dict(zip(("state", "conv_x", "conv_bc"), state))
        ys = [y] + list(cache.values())
        for i in range(4):
            yi, cache = ssm.ssm_decode_step(pp, cfg, xs[:, 256 + i], cache)
            ys.append(yi)
        ys += list(cache.values())
        outs.append([t.cpu() for t in ys])
    for a, b in zip(outs[1], outs[0]):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=0)


# --------------------------------------------------------- engine="scan" ---
def _scan_cfg(**over):
    from repro_torch.federated.client import ClientConfig
    from repro_torch.federated.server import FLConfig
    return FLConfig(**{**dict(n_clients=6, m=3, rounds=4, n_train=600,
                              n_val=100, n_test=100, eval_every=2,
                              shapley_max_iters=6,
                              client=ClientConfig(epochs=2,
                                                  batches_per_epoch=2,
                                                  batch_size=16)), **over})


def _max_err(a, b):
    from repro_torch.tree import tree_leaves
    return max(float((x - y).abs().max())
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


@pytest.mark.parametrize("over", [
    {"upload_codec": "quant8_topk"}, {"selector": "power_of_choice"},
    {"selector": "random"}, {"selector": "s_fedavg"},
    {"selector": "ucb", "shapley_impl": "batched"},
    {"selector": "greedyfed_dropout", "rounds": 5, "straggler_frac": 0.5,
     "privacy_sigma": 0.05}])
def test_scan_on_the_card_matches_the_batched_engine(cuda, over):
    """Captured and replayed, the scan makes the batched engine's choices
    on the card: equal selections, bytes and eval rounds, params, SVs and
    the eval history within 1e-6 (bitwise expected)."""
    import dataclasses
    from repro_torch.federated.server import run_federated
    cfg = _scan_cfg(**over)
    batched = run_federated(dataclasses.replace(cfg, engine="batched"),
                            device=cuda)
    scan = run_federated(dataclasses.replace(cfg, engine="scan"),
                         device=cuda)
    for a, b in zip(scan.selections, batched.selections):
        np.testing.assert_array_equal(a, b)
    assert scan.upload_bytes == batched.upload_bytes
    assert scan.download_bytes == batched.download_bytes
    assert scan.shapley_evals == batched.shapley_evals
    assert [r for r, _ in scan.test_acc] == [r for r, _ in batched.test_acc]
    np.testing.assert_allclose([v for _, v in scan.val_loss],
                               [v for _, v in batched.val_loss], atol=1e-6)
    np.testing.assert_allclose(scan.sv_final, batched.sv_final, atol=1e-6)
    assert _max_err(scan.params, batched.params) <= 1e-6
    assert scan.graph_launches is not None      # it was captured
    assert scan.dispatches == cfg.rounds + len(scan.test_acc)


def test_scan_segments_on_the_card_equal_the_whole_run(cuda):
    from repro_torch.federated.server import run_federated
    from repro_torch.tree import tree_leaves
    cfg = _scan_cfg(engine="scan", rounds=5, upload_codec="quant8_topk")
    whole = run_federated(cfg, device=cuda)
    seg = run_federated(cfg, device=cuda, rounds_per_segment=2)
    for a, b in zip(seg.selections, whole.selections):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(seg.sv_final, whole.sv_final)
    assert seg.test_acc == whole.test_acc and seg.val_loss == whole.val_loss
    for a, b in zip(tree_leaves(seg.params), tree_leaves(whole.params)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("impl", ["streaming", "batched", "serial"])
def test_scan_graph_holds_the_kernels_and_no_sync(cuda, impl):
    """The captured round launches each kernel of its path once; the
    replays run under set_sync_debug_mode("error"), which refuses a sync
    (shown here), so a finished run made none between replays."""
    from repro_torch.federated.server import run_federated
    res = run_federated(_scan_cfg(engine="scan", shapley_impl=impl,
                                  upload_codec="quant8_topk"), device=cuda)
    dense, serial = impl == "batched", impl == "serial"
    # the serial estimator's utilities are `model.loss`: no kernel
    assert res.graph_launches["round"] == {
        "prefix_avg": int(impl == "streaming"), "ce_loss": int(not serial),
        "cohort_gather": 1, "cohort_gather_shard": 0, "delta_codec": 1,
        "weighted_avg": int(dense), "flash_attention": 0,
        "flash_attention_bwd": 0, "flash_attention_wide": 0,
        "flash_attention_wide_bwd": 0}
    assert not any(res.graph_launches["eval"].values())
    assert np.isfinite(res.final_acc) and res.params["layer0"]["w"].is_cuda
    torch.cuda.set_sync_debug_mode("error")
    try:
        with pytest.raises(RuntimeError):
            torch.ones((1,), device=cuda).item()
    finally:
        torch.cuda.set_sync_debug_mode(0)


# ------------------------------------------------------ client sharding ---
@pytest.mark.parametrize("w", [1, 2, 4, 8])
def test_cohort_gather_shard_kernel_matches_plain(cuda, w):
    """The sharded entry at each of W blocks of the main path's stacks
    (padded to a multiple of W), with -0.0 and NaN payloads, bf16 rows of
    6 bytes, rows 2 and 4 bytes past a 16-byte boundary and a bool leaf:
    one launch a block for the tree, no host read, bitwise its plain
    version; the W blocks' int32 words summed on the card equal the dense
    kernel's rows in the packed layout; an id of N sets the error word."""
    from repro_torch.grid.shard import client_block, clients_padded
    from repro_torch.kernels.cohort_gather.kernel import (
        cohort_gather_shard_cuda, error_word, raise_on_error, shard_layout,
    )
    from repro_torch.kernels.cohort_gather.ref import cohort_gather_shard_ref
    gen = torch.Generator().manual_seed(11)
    tree = _gather_tree(gen, cuda)
    tree["bool"] = (torch.rand((50, 5), generator=gen) < 0.5).to(cuda)
    leaves = list(tree.values())
    sel = torch.tensor([7, 31, 2, 49, 18, 7], device=cuda)
    m, n, n_pad = len(sel), 50, clients_padded(50, w)
    row_bytes = [x[0].numel() * x.element_size() for x in leaves]
    offsets, total = shard_layout(row_bytes, m)
    packed = torch.zeros((total,), dtype=torch.uint8, device=cuda)
    dense = cohort_gather(tree, sel)
    for x, off, rb in zip((dense[k] for k in tree), offsets, row_bytes):
        packed[off:off + m * rb] = x.contiguous().reshape(-1).view(
            torch.uint8)
    summed = torch.zeros((total // 4,), dtype=torch.int32, device=cuda)
    for b in range(w):
        lo, hi = client_block(n, w, b)
        block = [x[lo:min(hi, n)] if hi <= n else torch.cat(
            [x[lo:], x.new_zeros((n_pad - n,) + x.shape[1:])])
            for x in leaves]
        word = error_word(cuda)
        before = kernels.LAUNCHES["cohort_gather_shard"]
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = cohort_gather_shard_cuda(block, sel, lo, n, word)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert kernels.LAUNCHES["cohort_gather_shard"] == before + 1
        raise_on_error(word, n)
        assert torch.equal(got, cohort_gather_shard_ref(block, sel, lo, n))
        summed += got
    assert torch.equal(summed.view(torch.uint8), packed)
    word = error_word(cuda)
    cohort_gather_shard_cuda(leaves, torch.tensor([3, n], device=cuda), 0,
                             n, word)
    assert int(word.item()) == n


@pytest.fixture
def one_rank_nccl(cuda):
    """A one-rank NCCL world on the card (NCCL refuses two ranks on one
    card) and its (1, 1) client mesh; destroyed after the test."""
    import os
    import socket
    import torch.distributed as dist
    from repro_torch.launch.mesh import client_mesh
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    torch.cuda.set_device(cuda.index or 0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    try:
        yield client_mesh(1, 1)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("over", [
    {"selector": "power_of_choice", "upload_codec": "quant8_topk"},
    {"straggler_frac": 0.5, "privacy_sigma": 0.05}])
def test_client_sharded_scan_on_one_nccl_rank_is_the_dense_scan(
        cuda, one_rank_nccl, over):
    """The sharded round (the state's all_gather and the cohort's
    all_reduce over NCCL, the sharded gather entry), captured thread-local
    and replayed, equals the dense scan bit for bit; its graph holds the
    sharded entry, not the dense one."""
    from repro_torch.federated.server import run_federated
    from repro_torch.launch import mesh
    from repro_torch.tree import tree_leaves
    cfg = _scan_cfg(engine="scan", **over)
    dense = run_federated(cfg, device=cuda)
    mesh.reset_collectives()
    got = run_federated(cfg, device=cuda, mesh=one_rank_nccl)
    assert mesh.COLLECTIVES == {"all_gather": 3, "all_reduce": 2}
    for a, b in zip(got.selections, dense.selections):
        np.testing.assert_array_equal(a, b)
    assert got.upload_bytes == dense.upload_bytes
    assert got.test_acc == dense.test_acc and got.val_loss == dense.val_loss
    np.testing.assert_array_equal(got.sv_final, dense.sv_final)
    np.testing.assert_array_equal(got.selection_counts,
                                  dense.selection_counts)
    for a, b in zip(tree_leaves(got.params), tree_leaves(dense.params)):
        assert torch.equal(a, b)
    assert got.graph_launches["round"]["cohort_gather_shard"] == 1
    assert got.graph_launches["round"]["cohort_gather"] == 0


# ------------------------------------------------- faults and quarantine ---
@pytest.mark.parametrize("over", [
    {"upload_codec": "quant8_topk"}, {"shapley_impl": "batched"},
    {"faults": FaultSpec(rate=1.0, kinds=("nan",))}])
def test_hardened_scan_on_the_card_is_bitwise_the_batched_engine(cuda,
                                                                  over):
    """Faults and the quarantine screen inside the captured round: equal
    selections, quarantined counts and bytes, params and SVs bitwise
    against the batched engine on the card."""
    import dataclasses
    from repro_torch.federated.server import run_federated
    from repro_torch.tree import tree_leaves
    cfg = _scan_cfg(**({"faults": FaultSpec(rate=0.4), "quarantine": True}
                       | over))
    batched = run_federated(dataclasses.replace(cfg, engine="batched"),
                            device=cuda)
    scan = run_federated(dataclasses.replace(cfg, engine="scan"),
                         device=cuda)
    assert scan.graph_launches is not None      # it was captured
    for a, b in zip(scan.selections, batched.selections):
        np.testing.assert_array_equal(a, b)
    assert scan.quarantined_total == batched.quarantined_total > 0
    assert scan.upload_bytes == batched.upload_bytes
    assert scan.test_acc == batched.test_acc
    np.testing.assert_array_equal(scan.sv_final, batched.sv_final)
    for a, b in zip(tree_leaves(scan.params), tree_leaves(batched.params)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("codes", [[0, 1, 3, 5, 0], [1, 1, 1, 1, 1],
                                   [0, 0, 0, 0, 3], [1, 0, 0, 0, 0]])
def test_screen_cohort_on_the_card_equals_the_cpu(cuda, codes):
    """The screen on the card: the same masks and counts as the CPU, the
    norms and cutoff at 1e-6 relative (f32 sums in another order)."""
    from repro_torch.faults import harden_cohort
    from repro_torch.faults.quarantine import screen_stats
    from repro_torch.tree import tree_leaves, tree_map
    gen = torch.Generator().manual_seed(11)
    params = {"w": torch.randn((784, 200), generator=gen),
              "b": torch.randn((200,), generator=gen)}
    stacked = tree_map(lambda p: p[None] + 0.05 * torch.randn(
        (5,) + tuple(p.shape), generator=gen), params)
    n_k = torch.tensor([40.0, 90.0, 120.0, 35.0, 260.0])
    spec = FaultSpec(kinds=("nan", "sign_flip", "crash"))
    to = (lambda t: t.to(cuda))
    want = harden_cohort(stacked, params, n_k, torch.tensor(codes),
                         faults=spec, quarantine=True, z=8.0)
    got = harden_cohort(tree_map(to, stacked), tree_map(to, params),
                        n_k.to(cuda), torch.tensor(codes, device=cuda),
                        faults=spec, quarantine=True, z=8.0)
    assert torch.equal(got.ok.cpu(), want.ok)
    assert int(got.quarantined) == int(want.quarantined)
    assert torch.equal(got.n_k_sv.cpu(), want.n_k_sv)
    for a, b in zip(tree_leaves(got.stacked), tree_leaves(want.stacked)):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-6, atol=0,
                                   equal_nan=True)
    parts = [screen_stats(h.stacked, p, z=8.0) for h, p in
             ((got, tree_map(to, params)), (want, params))]
    for a, b in zip(parts[0], parts[1]):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-6, atol=0,
                                   equal_nan=True)


def _quarantined_walks(cuda, m=5, r=60):
    """A cohort after the screen: rows 1 and 3 hold w_prev at weight
    2^-100, w_prev has entries below 2^-26, and walks start with one or
    both quarantined rows."""
    gen = torch.Generator().manual_seed(21)
    base = torch.randn((20000,), generator=gen) * 0.05
    base[::5] *= 2.0 ** -40
    stacked = base[None] + 0.05 * torch.randn((m, 20000), generator=gen)
    stacked[1] = stacked[3] = base
    n_k = torch.randint(20, 300, (m,), generator=gen).float()
    n_k[[1, 3]] = 2.0 ** -100
    heads = [[1, 3], [3, 1], [1], []]
    rows = []
    for i in range(r):
        head = heads[i % 4]
        rest = [k for k in torch.randperm(m, generator=gen).tolist()
                if k not in head]
        rows.append(head + rest)
    return stacked.to(cuda), n_k.to(cuda), torch.tensor(rows).to(cuda)


def test_prefix_avg_and_weighted_avg_bitwise_on_quarantined_walks(cuda):
    """Subnormal walk products and the dense oracle's clamped weights:
    both kernels equal their plain versions bit for bit, on the card and
    on the CPU."""
    from repro_torch.core.shapley_batched import prefix_weight_matrix
    stacked, n_k, perms = _quarantined_walks(cuda)
    got = prefix_avg({"w": stacked}, perms, n_k)["w"]
    assert torch.equal(got, prefix_avg_ref(stacked, perms, n_k))
    assert torch.equal(got.cpu(), prefix_avg_ref(stacked.cpu(), perms.cpu(),
                                                 n_k.cpu()))
    weights = prefix_weight_matrix(perms.cpu(), n_k.cpu()).reshape(
        -1, stacked.shape[0]).to(cuda)
    assert int((weights.sum(-1) < 1e-6).sum()) > 0     # clamped prefixes
    got = weighted_avg({"w": stacked}, weights)["w"]
    assert torch.equal(got, weighted_avg_ref(stacked, weights))
    assert torch.equal(got.cpu(), weighted_avg_ref(stacked.cpu(),
                                                   weights.cpu()))


# ------------------------------------------------------- the grid ---------
def _grid_spec():
    from repro_torch.grid import GridCell, GridSpec
    codec = {"upload_codec": "quant8_topk"}
    # the "sv" partition switches between greedyfed and s_fedavg on the
    # card by each replica's device strategy_id
    return GridSpec(_scan_cfg(engine="scan"), (
        GridCell("greedyfed", 0), GridCell("greedyfed", 1),
        GridCell("s_fedavg", 1),
        GridCell("greedyfed", 0, codec), GridCell("fedavg", 0),
        GridCell("fedavg", 1), GridCell("power_of_choice", 0),
        GridCell("power_of_choice", 1, {"eval_every": 3})))


def _assert_runs_bitwise(got, want):
    from repro_torch.tree import tree_leaves
    for a, b in zip(got.selections, want.selections):
        np.testing.assert_array_equal(a, b)
    assert got.upload_bytes == want.upload_bytes
    assert got.shapley_evals == want.shapley_evals
    assert got.test_acc == want.test_acc and got.val_loss == want.val_loss
    np.testing.assert_array_equal(got.sv_final, want.sv_final)
    for a, b in zip(tree_leaves(got.params), tree_leaves(want.params)):
        assert torch.equal(a, b)


def test_grid_on_the_card_is_bitwise_the_solo_runs(cuda):
    """Each partition's replicas in one captured round graph, replayed
    once a round: every cell makes its solo scan run on the card bit for
    bit, and each kernel of a replica's round sits in the graph once a
    replica."""
    from repro_torch.federated.server import run_federated
    from repro_torch.grid import run_grid
    spec = _grid_spec()
    grid = run_grid(spec, device=cuda)
    assert not grid.failures
    for cell, res in zip(spec.cells, grid.results):
        _assert_runs_bitwise(res, run_federated(cell.config(spec.base),
                                                device=cuda))
        assert res.params["layer0"]["w"].is_cuda
    for p in grid.partitions:
        s = len(p.cell_indices)
        assert p.replays["round"] == spec.base.rounds
        assert p.graph_launches["round"] == {
            "prefix_avg": s * p.needs_sv, "ce_loss": s * p.needs_sv,
            "cohort_gather": s, "cohort_gather_shard": 0,
            "delta_codec": s * (p.upload_codec != "identity"),
            "weighted_avg": 0, "flash_attention": 0,
            "flash_attention_bwd": 0, "flash_attention_wide": 0,
            "flash_attention_wide_bwd": 0}
        assert not any(p.graph_launches["eval"].values())


def test_grid_on_the_card_resumes_bitwise(cuda, tmp_path):
    from repro_torch.grid import run_grid
    spec = _grid_spec()
    whole = run_grid(spec, device=cuda)
    ckpt = str(tmp_path)
    assert run_grid(spec, device=cuda, rounds_per_segment=2,
                    checkpoint_dir=ckpt, max_segments=1) is None
    resumed = run_grid(spec, device=cuda, rounds_per_segment=2,
                       checkpoint_dir=ckpt)
    for a, b in zip(resumed.results, whole.results):
        _assert_runs_bitwise(a, b)
    assert resumed.partitions[0].dispatches == 1
    assert resumed.partitions[0].n_strategies == 2


def test_grid_on_the_card_matches_the_cpu(cuda):
    """The same grid and draws on the card and on the CPU: equal
    selections, bytes and eval rounds, floats at 1e-4."""
    from repro_torch.grid import run_grid
    spec = _grid_spec()
    card = run_grid(spec, device=cuda, rounds_per_segment=2)
    cpu = run_grid(spec, device="cpu", rounds_per_segment=2)
    for a, b in zip(card.results, cpu.results):
        for x, y in zip(a.selections, b.selections):
            np.testing.assert_array_equal(x, y)
        assert a.upload_bytes == b.upload_bytes
        assert [r for r, _ in a.test_acc] == [r for r, _ in b.test_acc]
        np.testing.assert_allclose([v for _, v in a.val_loss],
                                   [v for _, v in b.val_loss], atol=1e-4)
        np.testing.assert_allclose(a.sv_final, b.sv_final, atol=1e-4)
        assert _max_err(a.params, {k: {n: t.to(cuda) for n, t in v.items()}
                                   for k, v in b.params.items()}) <= 1e-4


def test_grid_capture_that_raises_degrades_to_cell_failures(cuda,
                                                            monkeypatch):
    """A partition whose capture raises ends its capture, drops its graphs
    and comes back as CellFailures; the other partitions still make their
    solo runs bit for bit, and the card captures and runs the same grid
    afterwards."""
    from repro_torch.engine import round_engine
    from repro_torch.federated.server import run_federated
    from repro_torch.grid import CellFailure, GridCell, GridSpec, run_grid
    real = round_engine.SegmentStep._round

    def failing(self):
        if (self.spec.round.needs_sv
                and torch.cuda.is_current_stream_capturing()):
            raise RuntimeError("injected capture failure")
        real(self)

    monkeypatch.setattr(round_engine.SegmentStep, "_round", failing)
    spec = GridSpec(_scan_cfg(engine="scan"), (
        GridCell("greedyfed", 0), GridCell("fedavg", 0),
        GridCell("greedyfed", 1)))
    grid = run_grid(spec, device=cuda)
    assert [f.cell for f in grid.failures] == [0, 2]
    assert all(isinstance(grid.results[i], CellFailure) for i in (0, 2))
    assert "injected capture failure" in grid.failures[0].error
    _assert_runs_bitwise(grid.results[1], run_federated(
        spec.cells[1].config(spec.base), device=cuda))
    monkeypatch.undo()
    again = run_grid(spec, device=cuda)
    assert not again.failures
    _assert_runs_bitwise(again.results[0], run_federated(
        spec.cells[0].config(spec.base), device=cuda))


# ------------------------------------------------------------- telemetry ---
def _telemetry_run(cuda, tmp_path, mode, **over):
    """One scan run of the small config under a telemetry mode: "off",
    "host" (an in-memory sink), "live" (the live tap) or "trace" (a
    capture window: the round captured as one graph a stage)."""
    from repro_torch.federated.server import run_federated
    from repro_torch.telemetry import Telemetry
    cfg = _scan_cfg(engine="scan", upload_codec="quant8_topk", **over)
    kw = {"live": {"live_tap": True},
          "trace": {"trace_dir": str(tmp_path / "trace")}}.get(mode, {})
    tel = None if mode == "off" else Telemetry(**kw)
    return run_federated(cfg, device=cuda, telemetry=tel), tel


def _syncs(fn):
    import warnings
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return out, sum("synchroniz" in str(w.message) for w in caught)


@pytest.mark.parametrize("mode", ["host", "live", "trace"])
def test_scan_telemetry_on_the_card_is_bitwise_the_run_without(cuda, tmp_path,
                                                               mode):
    """Off, host sink, live tap and the stage-timed capture make the same
    run on the card bit for bit; every one replays under
    set_sync_debug_mode("error") (the engine turns it on around the
    replays, so a sync in a replay raises)."""
    from repro_torch.telemetry import validate_events
    from repro_torch.tree import tree_leaves
    off, _ = _telemetry_run(cuda, tmp_path, "off")
    on, tel = _telemetry_run(cuda, tmp_path, mode)
    for a, b in zip(on.selections, off.selections):
        np.testing.assert_array_equal(a, b)
    assert on.test_acc == off.test_acc and on.val_loss == off.val_loss
    np.testing.assert_array_equal(on.sv_final, off.sv_final)
    assert on.upload_bytes == off.upload_bytes
    assert on.dispatches == off.dispatches
    for a, b in zip(tree_leaves(on.params), tree_leaves(off.params)):
        assert torch.equal(a, b)
    validate_events(tel.events)
    kinds = [e["event"] for e in tel.events]
    assert kinds.count("round_metrics") == len(on.selections)
    if mode == "live":
        taps = [e for e in tel.events if e["event"] == "round_tap"]
        assert sorted(e["round"] for e in taps) == list(range(4))
        assert [e["selections"] for e in sorted(taps, key=lambda e:
                                                e["round"])] == \
            [s.tolist() for s in off.selections]
    if mode == "trace":
        (prof,) = [e for e in tel.events if e["event"] == "profile"]
        assert prof["source"] == "graph_events"
        assert {"select", "train", "codec", "shapley", "aggregate",
                "eval"} <= set(prof["stage_wall_s"])


def test_host_sink_adds_no_host_sync_to_a_scan_run(cuda, tmp_path):
    """The sink reads what the segment reads back anyway: a scan run with
    it makes as many synchronizing calls as one without it."""
    _telemetry_run(cuda, tmp_path, "off")          # build, warm caches
    _, off = _syncs(lambda: _telemetry_run(cuda, tmp_path, "off"))
    _, host = _syncs(lambda: _telemetry_run(cuda, tmp_path, "host"))
    assert host == off


def test_tap_ring_is_pinned_and_fed_by_the_graph(cuda):
    from repro_torch.engine import (
        SegmentCarry, make_scan_spec, make_segment_step, scan_operands,
    )
    from repro_torch.engine.round_engine import round_plan
    from repro_torch.federated.draws import stack_rounds
    from repro_torch.federated.server import setup_run
    cfg = _scan_cfg(engine="scan")
    s = setup_run(cfg, device=cuda)
    spec = make_scan_spec(cfg, (s.sel_spec,), live_tap=True)
    plan = round_plan(spec.round, cfg.client, (s.sel_spec,), cfg.n_clients,
                      cfg.m, s.params, s.n_valid.cpu().numpy())
    step = make_segment_step(s.model, cfg.client, spec, scan_operands(cfg, s))
    (ring,) = step.tap_rings
    assert ring.host_rec.is_pinned() and ring.host_seq.is_pinned()
    step([SegmentCarry(s.params, s.sel_state,
                       torch.zeros((), dtype=torch.int64, device=cuda))], 0,
         [stack_rounds([s.draws.round(t, plan) for t in range(cfg.rounds)])])
    torch.cuda.synchronize()
    assert step.graphs is not None
    assert ring.seq_np.tolist() == list(range(1, cfg.rounds + 1))
    assert [ring.record(t)["round"] for t in range(cfg.rounds)] == \
        list(range(cfg.rounds))


def test_stage_events_sum_within_the_replays_time(cuda, tmp_path):
    res, tel = _telemetry_run(cuda, tmp_path, "trace", rounds=6)
    (prof,) = [e for e in tel.events if e["event"] == "profile"]
    total = sum(prof["stage_wall_s"].values())
    replays = sum(res.round_time_s)
    assert 0.0 < total <= replays * 1.01


# ---------------------------- the serial estimator in the captured round --
def test_graph_flow_nodes_on_the_card(cuda):
    """A captured WHILE node holding an IF node: the loop runs the passes
    its device flag allows (none when it is false on entry), the IF skips
    its body where its flag is false, a body allocates from the graph's
    pool, and that pool is released with the graph."""
    from repro_torch.engine import graph_flow
    x, n, hits = (torch.zeros((), device=cuda) for _ in range(3))
    go = torch.zeros((), dtype=torch.bool, device=cuda)

    def body():
        x.add_(1.0)
        odd = torch.remainder(x, 2.0) == 1.0
        graph_flow.if_(odd, lambda: hits.add_(1.0), (hits,))
        scratch = torch.ones((4096,), device=cuda) * x   # pool memory
        x.copy_(scratch[4095])
        go.copy_(x < n)

    torch.cuda.synchronize()
    base = torch.cuda.memory_reserved(cuda)
    graph_flow.reset_nodes()
    g, pool = torch.cuda.CUDAGraph(), torch.cuda.graph_pool_handle()
    with graph_flow.capture_pool(pool), torch.cuda.graph(g, pool=pool):
        x.zero_()
        hits.zero_()
        go.copy_(x < n)
        graph_flow.while_(go, body, (x, hits), max_passes=100)
    assert graph_flow.NODES == {"while": 1, "if": 1}
    assert graph_flow.WHILE_BODIES == [1]
    for target, want_hits in ((5.0, 3.0), (0.0, 0.0), (8.0, 4.0)):
        n.fill_(target)
        g.replay()
        torch.cuda.synchronize()
        assert (float(x), float(hits)) == (target, want_hits)
    torch.cuda.empty_cache()        # the live graph keeps its pool
    n.fill_(3.0)
    g.replay()
    torch.cuda.synchronize()
    assert (float(x), float(hits)) == (3.0, 2.0)
    del g
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    assert torch.cuda.memory_reserved(cuda) <= base


@pytest.mark.parametrize("over", [
    {"upload_codec": "quant8_topk"},
    {"upload_codec": "quant8_topk", "quarantine": True,
     "faults": FaultSpec(rate=0.4, kinds=("nan", "sign_flip", "crash"))}])
def test_serial_scan_on_the_card_matches_batched_and_the_cpu(cuda, over):
    """The serial estimator under the captured round: one WHILE node
    holding M^2 IF nodes; the card's scan equals its batched engine
    (counts equal, floats within 1e-6, bitwise expected) and the CPU's
    scan (counts equal, floats at 1e-4); with max_iters 40 the WHILE
    stops early, on convergence."""
    import dataclasses
    from repro_torch.engine import graph_flow
    from repro_torch.federated.server import run_federated
    cfg = _scan_cfg(engine="scan", shapley_impl="serial",
                    shapley_max_iters=40, **over)
    graph_flow.reset_nodes()
    scan = run_federated(cfg, device=cuda)
    assert graph_flow.NODES["while"] == 1
    assert graph_flow.WHILE_BODIES == [cfg.m ** 2]
    batched = run_federated(dataclasses.replace(cfg, engine="batched"),
                            device=cuda)
    cpu = run_federated(cfg, device="cpu")
    for other, atol in ((batched, 1e-6), (cpu, 1e-4)):
        for a, b in zip(scan.selections, other.selections):
            np.testing.assert_array_equal(a, b)
        assert scan.upload_bytes == other.upload_bytes
        assert scan.round_shapley_evals == other.round_shapley_evals
        assert scan.round_shapley_iterations == \
            other.round_shapley_iterations
        assert scan.quarantined_total == other.quarantined_total
        np.testing.assert_allclose(scan.sv_final, other.sv_final, atol=atol)
        assert _max_err(scan.params, {k: {n: t.to(cuda) for n, t in
                                          v.items()}
                                      for k, v in other.params.items()}
                        ) <= atol
    iters = [n for n in scan.round_shapley_iterations if n]
    assert iters and max(iters) < 40


def test_captured_serial_round_at_huge_eps_evaluates_two_utilities(cuda):
    """eps = 1e9 truncates every round between rounds: the WHILE node's
    flag is false on entry, so a round evaluates U(w^t) and U(w^{t+1})
    only and values no one."""
    from repro_torch.federated.server import run_federated
    cfg = _scan_cfg(engine="scan", shapley_impl="serial", shapley_eps=1e9)
    res = run_federated(cfg, device=cuda)
    assert res.round_shapley_evals == (2,) * cfg.rounds
    assert res.round_shapley_iterations == (0,) * cfg.rounds
    assert not res.sv_final.any()


def test_flat_codecs_on_the_card_are_bitwise_the_cpu(cuda):
    """The flat codec layer on five stacked full-width MLP deltas: the
    card's rows bitwise the CPU's, and each client's tree roundtrip on the
    card bitwise the per-leaf codec's on the CPU."""
    from repro_torch.federated.compression import (
        FLAT_CODECS, codec_roundtrip, flat_codec_roundtrip, flat_roundtrip,
        flat_sizes,
    )
    from repro_torch.models.mlp_cnn import make_mlp
    from repro_torch.tree import tree_leaves, tree_map, tree_unflatten
    gen = torch.Generator().manual_seed(21)
    ref = make_mlp(784, (200, 100), 10).init(gen, torch.device("cpu"))
    sizes = flat_sizes(ref)
    rows = 0.01 * torch.randn((5, sum(sizes)), generator=gen)
    rows[:, ::11] = rows[:, 3:4]           # exact |.| ties in every leaf
    news = [tree_unflatten(ref, [r + s.reshape(r.shape) for r, s in zip(
        tree_leaves(ref), torch.split(row, list(sizes)))]) for row in rows]
    on_card = (lambda tree: tree_map(lambda x: x.to(cuda), tree))
    for codec in FLAT_CODECS:
        want = flat_roundtrip(codec, rows, sizes)
        got = flat_roundtrip(codec, rows.to(cuda), sizes).cpu()
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        for new in news:
            card = flat_codec_roundtrip(codec, on_card(new), on_card(ref))
            for a, b in zip(tree_leaves(card),
                            tree_leaves(codec_roundtrip(codec, new, ref))):
                assert torch.equal(a.cpu(), b)


# ------------------------------------------- the dry-run's counts, on card --

def _phase3_calls():
    """(name, the wrapper's inputs on a device, a call of the wrapper):
    phase 3's main-path shapes (five full-width MLPs, R = 250 walks; 1250
    prefix models x 500 rows x 10 classes; the four (N = 50) client
    stacks; the Danube prefill layer in bf16 and f32; the TinyLlama
    training layer's backward, both dtypes)."""
    def mlp(dev):
        g = torch.Generator().manual_seed(0)
        shapes = {"l0": {"w": (784, 200), "b": (200,)},
                  "l1": {"w": (200, 100), "b": (100,)},
                  "l2": {"w": (100, 10), "b": (10,)}}
        return {k: {n: torch.randn((5, *s), generator=g).to(dev)
                    for n, s in v.items()} for k, v in shapes.items()}

    def perms(dev):
        g = torch.Generator().manual_seed(1)
        return torch.stack([torch.randperm(5, generator=g)
                            for _ in range(250)]).to(dev)

    def stacks(dev):
        g = torch.Generator().manual_seed(2)
        return {"xs": torch.randn((50, 158, 784), generator=g).to(dev),
                "ys": torch.randint(0, 10, (50, 158), generator=g).to(dev),
                "n_valid": torch.full((50,), 158).to(dev),
                "sigma": torch.rand(50, generator=g).to(dev)}

    def attn(dev, dtype, b, s_len, hq, kh, hd, grad=False):
        g = torch.Generator().manual_seed(3)
        return [torch.randn(sh, generator=g).to(dev, dtype).requires_grad_(
            grad) for sh in ((b, s_len, hq, hd), (b, s_len, kh, hd),
                             (b, s_len, kh, hd))]

    def backward(q, k, v):
        from repro_torch.kernels.flash_attention import flash_attention_gqa
        flash_attention_gqa(q, k, v).sum().backward()

    from repro_torch.kernels.flash_attention import flash_attention_gqa
    return [
        ("prefix_avg", lambda d: (mlp(d), perms(d), torch.full(
            (5,), 100.0, device=d)), prefix_avg),
        ("ce_loss", lambda d: (torch.randn((1250, 500, 10)).to(d),
                               torch.arange(500, device=d) % 10), ce_loss),
        ("cohort_gather", lambda d: (stacks(d), np.array([7, 31, 2, 49, 18])),
         cohort_gather),
        ("delta_codec", lambda d: (mlp(d), {k: {n: t[0] for n, t in v.items()}
                                            for k, v in mlp(d).items()},
                                   "quant8_topk"), delta_codec_roundtrip),
        ("weighted_avg", lambda d: (mlp(d), torch.rand((1250, 5)).to(d)),
         weighted_avg),
        ("flash_attention", lambda d: attn(d, torch.bfloat16, 4, 8192, 32, 8,
                                           120),
         lambda q, k, v: flash_attention_gqa(q, k, v, window=4096)),
        ("flash_attention", lambda d: attn(d, torch.float32, 4, 8192, 32, 8,
                                           120),
         lambda q, k, v: flash_attention_gqa(q, k, v, window=4096)),
        ("flash_attention_bwd", lambda d: attn(d, torch.bfloat16, 4, 2048,
                                               32, 4, 64, grad=True),
         backward),
        ("flash_attention_bwd", lambda d: attn(d, torch.float32, 4, 2048, 32,
                                               4, 64, grad=True), backward),
    ]


@pytest.mark.parametrize("case", range(9), ids=[
    "prefix_avg", "ce_loss", "cohort_gather", "delta_codec", "weighted_avg",
    "flash_bf16", "flash_f32", "flash_bwd_bf16", "flash_bwd_f32"])
def test_wrapper_meta_count_equals_its_card_count(cuda, case):
    """Each wrapper at phase 3's shapes, counted by `launch.compat.Count`
    on meta and on the card: the same FLOPs, bytes and kernel terms, the
    kernel launched on the card (and not on meta)."""
    from repro_torch.launch.compat import Count
    name, make, call = _phase3_calls()[case]
    counts = {}
    for dev in ("meta", "cuda"):
        args = make(dev)
        before = kernels.LAUNCHES[name]
        with Count() as c:
            call(*args)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES[name] == before + (dev == "cuda")
        counts[dev] = c
        del args
    assert counts["meta"].by_kernel[name]["calls"] == 1
    assert counts["meta"].flops == counts["cuda"].flops
    assert counts["meta"].bytes == counts["cuda"].bytes
    assert counts["meta"].by_kernel == counts["cuda"].by_kernel


def test_reduced_train_step_meta_count_equals_its_card_count(cuda):
    """TinyLlama's head structure at 2 layers and d_model 256, bf16, remat,
    B = 2 x S = 2048 (the flash kernels, forward and backward): the meta
    count equals the card's, FLOPs, bytes, kernels and live-byte peak."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import count_step
    from repro_torch.launch.shapes import InputShape
    cfg = dataclasses.replace(get_config("tinyllama_1_1b").reduced(
        n_layers=2), dtype="bfloat16", remat=True)
    shape = InputShape("reduced", 2048, 2, "train")
    before = dict(kernels.LAUNCHES)
    meta = count_step(cfg, shape, "meta")
    card = count_step(cfg, shape, cuda)
    assert kernels.LAUNCHES["flash_attention"] == \
        before["flash_attention"] + 4
    assert kernels.LAUNCHES["flash_attention_bwd"] == \
        before["flash_attention_bwd"] + 2
    for key in ("flops", "bytes_accessed", "compute_s", "argument_bytes",
                "peak_bytes", "kernels"):
        assert meta[key] == card[key], key


# ------------------------------------------- the CIFAR-10 task (the CNN) --

def test_resolve_device_turns_cudnn_deterministic_on(cuda):
    """The card's entry points pick cuDNN's deterministic algorithms by its
    heuristics (no autotuning), TF32 off."""
    from repro_torch.device import resolve_device
    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.benchmark = True
    assert resolve_device() == cuda
    assert torch.backends.cudnn.deterministic
    assert not torch.backends.cudnn.benchmark
    assert not torch.backends.cudnn.allow_tf32


def test_cnn_batched_rounds_repeat_bitwise_and_equal_the_loop(cuda):
    """Two rounds of the full-width CNN (dataset="cifar10", the reference's
    defaults otherwise), the batched engine twice and the loop engine
    once: cuDNN's convolution backward in training, the per-model utility
    forward over the 1,250 prefix models; all three runs bit for bit."""
    import dataclasses
    from repro_torch.federated.server import FLConfig, run_federated
    from repro_torch.tree import tree_leaves
    cfg = FLConfig(dataset="cifar10", rounds=2, eval_every=2,
                   upload_codec="quant8_topk")
    runs = [run_federated(dataclasses.replace(cfg, engine=e))
            for e in ("batched", "batched", "loop")]
    first = runs[0]
    assert first.params["dense0"]["w"].shape == (4096, 128)
    assert np.abs(first.sv_final).max() > 0
    for other in runs[1:]:
        for a, b in zip(other.selections, first.selections):
            np.testing.assert_array_equal(a, b)
        assert other.upload_bytes == first.upload_bytes
        assert other.test_acc == first.test_acc
        np.testing.assert_array_equal(other.sv_final, first.sv_final)
        for a, b in zip(tree_leaves(other.params), tree_leaves(first.params)):
            assert torch.equal(a, b)


def _stacked_cnn(gen, m, scale, device):
    from repro_torch.models.mlp_cnn import make_cnn
    from repro_torch.tree import tree_map
    base = make_cnn().init(gen, torch.device("cpu"))
    stacked = tree_map(lambda p: (p[None] + scale * torch.randn(
        (m,) + p.shape, generator=gen)).to(device), base)
    return stacked, tree_map(lambda p: p.to(device), base)


@pytest.mark.parametrize("kernel", ["prefix_avg", "weighted_avg",
                                    "cohort_gather", "ce_loss"])
def test_kernels_at_the_cnn_shapes(cuda, kernel):
    """Each kernel of the cifar10 path as that path calls it on the
    full-width CNN (8 leaves, 545,098 parameters, M = 5, R = 250 walks):
    prefix_avg's 1,250 prefix models in one launch, weighted_avg's
    dense-oracle call and cohort_gather of the cifar10 client stacks
    bitwise their plain versions; ce_loss on the prefix models' logits
    over 500 validation images at rtol 1e-5 a model (the card's expf and
    logf against PyTorch's logsumexp)."""
    from repro_torch.core.shapley_batched import prefix_weight_matrix
    from repro_torch.data.synth import make_dataset
    from repro_torch.federated.server import FLConfig, setup_run
    from repro_torch.models.mlp_cnn import make_cnn
    from repro_torch.tree import tree_leaves
    gen = torch.Generator().manual_seed(35)
    m, r = 5, 250
    before = kernels.LAUNCHES[kernel]
    if kernel == "cohort_gather":
        s = setup_run(FLConfig(dataset="cifar10"), device=cuda)
        stacks = {"xs": s.xs, "ys": s.ys, "nv": s.n_valid}
        ids = torch.tensor([7, 31, 2, 49, 18], device=cuda)
        got = cohort_gather(stacks, ids.cpu().numpy())
        assert kernels.LAUNCHES[kernel] == before + 1
        for name, table in stacks.items():
            want = cohort_gather_ref(table.reshape(table.shape[0], -1), ids)
            assert got[name].shape == (m,) + table.shape[1:]
            assert torch.equal(got[name].reshape(m, -1), want)
        return
    stacked, _ = _stacked_cnn(gen, m, 0.1, cuda)
    perms = _walks(gen, r, m, cuda)
    n_k = torch.randint(20, 300, (m,), generator=gen).float().to(cuda)
    if kernel == "weighted_avg":
        w = prefix_weight_matrix(perms, n_k).reshape(r * m, m)
        got = weighted_avg(stacked, w)
        assert kernels.LAUNCHES[kernel] == before + 1
        for x, y in zip(tree_leaves(stacked), tree_leaves(got)):
            assert torch.equal(y.reshape(r * m, -1),
                               weighted_avg_ref(x.reshape(m, -1), w))
        return
    models = prefix_avg(stacked, perms, n_k)
    if kernel == "prefix_avg":
        assert kernels.LAUNCHES[kernel] == before + 1
        for x, y in zip(tree_leaves(stacked), tree_leaves(models)):
            assert torch.equal(y.reshape(r * m, -1),
                               prefix_avg_ref(x.reshape(m, -1), perms, n_k))
        return
    data = make_dataset("cifar10", n_train=10, n_val=500, n_test=10, seed=0)
    x = torch.as_tensor(data.x_val, device=cuda)
    y = torch.as_tensor(data.y_val, dtype=torch.int64, device=cuda)
    with torch.no_grad():
        logits = make_cnn().apply_batched(models, x)
    got = ce_loss(logits, y)
    assert kernels.LAUNCHES[kernel] == before + 1
    want = torch.mean(ce_loss_ref(logits, y), dim=-1)
    assert got.shape == (r * m,)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0)
