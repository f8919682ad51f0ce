"""Injected random draws of a federated run.

The reference draws from JAX threefry keys, whose streams torch cannot
reproduce.  So every random draw of a port run goes through one small
interface, `RunDraws`:

  * `init_params(model)`   — the initial server model;
  * `round(t, plan)`       — all of round t's draws, made before the round
    in one fixed order (`RoundDraws`): the selection draw (`random`'s
    cohort or the Gumbel noise of `power_of_choice` and `s_fedavg`, when
    the strategy reads one), then each cohort slot's minibatch draws and
    noise leaves, then the walks of GTG-Shapley: the (R, M) walks of the
    streaming and dense estimators, or the serial estimator's block of
    max_iters (M, M) batches (`core.shapley.permutation_block`), drawn
    whole whatever the round's convergence uses, as the reference splits
    one key a MC round.

A round's draws are indexed by (round, slot), never by the client a slot
holds, so they can be made before selection and staged on the card for a
captured run: the minibatch rows of slot i come out on the device as
`(bits * n_valid[sel[i]]) >> 31` from 31-bit integers (`minibatch_rows`),
where `floor(u * n)` in float32 would round up to n for large n.  A draw
source may instead give every client's index table for each slot (a test
replays the reference's `randint` tables that way), and the device picks
the selected client's.  All three engines take the same draws, so one
seed gives one run on every engine, on the CPU and on the card.

`TorchDraws` is the default: one CPU `torch.Generator` seeded from the
config's seed and consumed in call order.  `round` returns host tensors;
the engines move them to the run's device.  A resumed grid needs each
source where the killed run left it: `state()` is a uint8 host tensor that
`set_state` restores (the generator's state for `TorchDraws`); only a
checkpointed grid calls them.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Protocol, Sequence

import torch

from repro_torch.core.selection import SelectionDraw

ROW_BITS = 31      # minibatch draws are uniform on [0, 2^31)


class DrawPlan(NamedTuple):
    """What one round draws; fixed for a run."""
    selection: tuple    # the selection draws: "choice" and / or "gumbel"
                        # (`SelectorSpec.selection_draws`)
    n_clients: int      # N
    m: int              # cohort slots
    n_steps: int        # E * B minibatches a slot
    batch_size: int
    shapes: tuple       # the noise leaves' shapes, in tree order
    n_perms: int        # walks of the round (0: none)
    n_valid: tuple      # (N,) valid rows per client, as host ints
    walk_block: bool = False   # the walks are the serial estimator's
                               # block: n_perms // m batches of (M, M)


class RoundDraws(NamedTuple):
    """Round t's draws (or a segment's, stacked on a leading round axis)."""
    selection: SelectionDraw
    rows: torch.Tensor       # (M, S, B) int64 31-bit draws, or (M, N, S, B)
                             # index tables, one per client
    noise: list              # leaves (M, *shape), tree order
    walks: Optional[torch.Tensor]   # (R, M) int64, or None

    def to(self, device) -> "RoundDraws":
        return _map(lambda x: x.to(device), self)


class RunDraws(Protocol):
    def init_params(self, model): ...

    def round(self, t: int, plan: DrawPlan) -> RoundDraws: ...

    def state(self) -> torch.Tensor: ...

    def set_state(self, state: torch.Tensor) -> None: ...


def _map(fn, rd: RoundDraws) -> RoundDraws:
    opt = (lambda x: None if x is None else fn(x))
    return RoundDraws(
        SelectionDraw(opt(rd.selection.choice), opt(rd.selection.gumbel)),
        fn(rd.rows), [fn(x) for x in rd.noise], opt(rd.walks))


def stack_rounds(rounds: Sequence[RoundDraws]) -> RoundDraws:
    """K rounds' draws stacked on a leading round axis."""
    first = rounds[0]

    def stack(get):
        return None if get(first) is None else torch.stack(
            [get(r) for r in rounds])

    return RoundDraws(
        SelectionDraw(stack(lambda r: r.selection.choice),
                      stack(lambda r: r.selection.gumbel)),
        stack(lambda r: r.rows),
        [stack(lambda r, j=j: r.noise[j]) for j in range(len(first.noise))],
        stack(lambda r: r.walks))


def round_at(staged: RoundDraws, k: torch.Tensor) -> RoundDraws:
    """Round k of stacked draws, with k a (1,) device index: a gather on
    the card, no host read."""
    return _map(lambda x: x.index_select(0, k)[0], staged)


def minibatch_rows(rows: torch.Tensor, sel: torch.Tensor,
                   n_valid: torch.Tensor) -> torch.Tensor:
    """(M, S, B) minibatch row indices of the cohort `sel`, each in
    [0, max(n_valid[sel[i]], 1)), on the inputs' device."""
    sel = sel.to(torch.int64)
    n = n_valid.index_select(0, sel) if rows.dim() == 3 else None
    return cohort_rows(rows, sel, n)


def cohort_rows(rows: torch.Tensor, sel: torch.Tensor,
                n_sel: Optional[torch.Tensor]) -> torch.Tensor:
    """`minibatch_rows` from the cohort's own (M,) valid-row counts `n_sel`
    (the form a client-sharded round takes, whose counts come with the
    cohort's gathered rows)."""
    if rows.dim() == 3:       # 31-bit draws: scale by the client's rows
        return (rows * n_sel.to(torch.int64)[:, None, None]) >> ROW_BITS
    slots = torch.arange(rows.shape[0], device=rows.device)
    return rows[slots, sel.to(torch.int64)]   # every client's table


class TorchDraws:
    """Draws from one seeded CPU `torch.Generator`."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.gen = torch.Generator().manual_seed(int(seed))

    def init_params(self, model):
        cpu = model.init(self.gen, torch.device("cpu"))
        return {k: {n: t.to(self.device) for n, t in v.items()}
                for k, v in cpu.items()}

    def round(self, t, plan):
        from repro_torch.core.shapley import permutation_block
        from repro_torch.core.shapley_batched import _draw_perms
        g, n = self.gen, plan.n_clients
        choice = gumbel = walks = None
        if "choice" in plan.selection:
            choice = torch.randperm(n, generator=g)[:plan.m]
        if "gumbel" in plan.selection:
            u = torch.rand((n,), generator=g)
            tiny = torch.finfo(torch.float32).tiny
            gumbel = -torch.log(-torch.log(torch.clamp(u, tiny, 1.0)))
        rows, noise = [], [[] for _ in plan.shapes]
        for _ in range(plan.m):
            rows.append(torch.randint(0, 1 << ROW_BITS,
                                      (plan.n_steps, plan.batch_size),
                                      generator=g))
            for leaves, shape in zip(noise, plan.shapes):
                leaves.append(torch.randn(shape, generator=g))
        if plan.walk_block:
            walks = permutation_block(g, plan.m, plan.n_perms // plan.m)
        elif plan.n_perms:
            walks = _draw_perms(g, plan.m, plan.n_perms)
        return RoundDraws(SelectionDraw(choice, gumbel), torch.stack(rows),
                          [torch.stack(leaves) for leaves in noise], walks)

    def state(self):
        return self.gen.get_state()

    def set_state(self, state):
        self.gen.set_state(state.to(torch.uint8).cpu())
