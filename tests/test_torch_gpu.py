"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs a CUDA card (marker `gpu`) and skips without one.
The file imports no JAX, so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py

Tolerances: prefix_avg bitwise (the kernel rounds the same operations as
the plain walk, in the same order); ce_loss means at 1e-5 relative (the
card's expf/logf against PyTorch's logsumexp), per-row losses at 1e-5
relative plus 1e-6 * max|logit| absolute, since logsumexp - gold cancels
on rows the gold logit dominates.
"""
import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels.ce_loss.kernel import ce_loss_cuda
from repro_torch.kernels.ce_loss.ops import ce_loss
from repro_torch.kernels.ce_loss.ref import ce_loss_ref
from repro_torch.kernels.prefix_avg.ops import prefix_avg
from repro_torch.kernels.prefix_avg.ref import prefix_avg_ref

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
    (5, 5000, 11, torch.bfloat16)])
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
    # each valued round builds the 6 MLP leaves' prefixes and scores them
    valued = (res.shapley_evals - 2 * cfg.rounds) // (6 * cfg.m)
    assert valued > 0
    assert kernels.LAUNCHES["prefix_avg"] == 6 * valued
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
