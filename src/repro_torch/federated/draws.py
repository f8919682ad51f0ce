"""Injected random draws of a federated run.

The reference draws from JAX threefry keys, whose streams torch cannot
reproduce.  So every random draw of a port run goes through one small
interface, `RunDraws`:

  * `init_params(model)`          — the initial server model;
  * `client(t, i, n_steps, batch_size, n_valid, shapes)` -> (idx, noise):
    client i's (E*B, batch) minibatch index table in round t and its
    standard-normal noise leaves, in `tree_leaves` order;
  * `perms(t, m, n_perms)`        — the (R, M) walks of streaming
    GTG-Shapley in round t;
  * `perm_batches(t, m)`          — a callable giving the serial
    estimator's next (M, M) batch of walks;
  * `choice(t, n, m)`             — `random`'s cohort (m of n without
    replacement);
  * `gumbel(t, n)`                — the (N,) Gumbel noise of
    `power_of_choice` and `s_fedavg`.

`TorchDraws` is the default: one CPU `torch.Generator` seeded from the
config's seed and consumed in call order, its draws moved to the run's
device, so one seed gives one run on the CPU and on the card.  A test
hands the reference's own draws to the port through the same interface.
"""
from __future__ import annotations

from typing import Callable, Protocol, Sequence

import torch


class RunDraws(Protocol):
    def init_params(self, model): ...

    def client(self, t: int, i: int, n_steps: int, batch_size: int,
               n_valid: int, shapes: Sequence[tuple]
               ) -> tuple[torch.Tensor, list[torch.Tensor]]: ...

    def perms(self, t: int, m: int, n_perms: int) -> torch.Tensor: ...

    def perm_batches(self, t: int, m: int) -> Callable[[], torch.Tensor]: ...

    def choice(self, t: int, n: int, m: int) -> torch.Tensor: ...

    def gumbel(self, t: int, n: int) -> torch.Tensor: ...


class TorchDraws:
    """Draws from one seeded CPU `torch.Generator`, moved to `device`."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.gen = torch.Generator().manual_seed(int(seed))

    def init_params(self, model):
        cpu = model.init(self.gen, torch.device("cpu"))
        return {k: {n: t.to(self.device) for n, t in v.items()}
                for k, v in cpu.items()}

    def client(self, t, i, n_steps, batch_size, n_valid, shapes):
        idx = torch.randint(0, max(int(n_valid), 1), (n_steps, batch_size),
                            generator=self.gen)
        noise = [torch.randn(s, generator=self.gen).to(self.device)
                 for s in shapes]
        return idx.to(self.device), noise

    def perms(self, t, m, n_perms):
        from repro_torch.core.shapley_batched import _draw_perms
        return _draw_perms(self.gen, m, n_perms).to(self.device)

    def perm_batches(self, t, m):
        from repro_torch.core.shapley import _permutation_batch
        return lambda: _permutation_batch(self.gen, m).to(self.device)

    def choice(self, t, n, m):
        return torch.randperm(n, generator=self.gen)[:m].to(self.device)

    def gumbel(self, t, n):
        u = torch.rand((n,), generator=self.gen)
        tiny = torch.finfo(torch.float32).tiny
        return (-torch.log(-torch.log(torch.clamp(u, tiny, 1.0)))
                ).to(self.device)
