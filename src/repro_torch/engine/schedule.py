"""Virtual-clock systems model: latencies, deadlines, time-derived stragglers.

The port's own numpy copy of `repro/engine/schedule.py` (equal tables for
the same rng).

The paper's Section IV induces stragglers by *drawing* E_k ~ U{1..E} for a
random x-fraction of clients.  Real deployments produce stragglers from
*time*: a client has a compute rate and a link bandwidth, the server sets a
round deadline tau, and the client completes however many local epochs fit:

    E_k = clip( floor( (tau - t_comm_k) / t_epoch_k ), 0, E )

This module provides that model as a first-class workload.  Per-client
epoch times are drawn log-normal (the canonical device-speed distribution;
cf. heterogeneity-aware FL systems work), optionally scaled by the client's
dataset size (more data => a slower epoch).  The communication term charges
a full model download + upload per round at the client's link speed.

A `VirtualClock` accumulates simulated wall time across rounds — the round
duration is the slowest selected client, cut off at the deadline — so runs
report time-to-accuracy in *simulated seconds*, not just rounds.  All of it
is host-side numpy bookkeeping: the derived `E_k` feeds the same
`epochs_k` argument of the batched/loop engines, so the compiled round step
is untouched by scheduling policy.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class ScheduleConfig:
    """Timing model for one federated deployment."""
    deadline_s: float = 1.0          # tau: round deadline (simulated seconds)
    epoch_time_mean_s: float = 0.25  # median per-epoch compute time
    epoch_time_sigma: float = 0.5    # log-normal spread of device speeds
    uplink_bytes_per_s: float = 1e8
    downlink_bytes_per_s: float = 4e8
    data_scaled: bool = True         # epoch time grows with n_k / mean(n_k)


class ClientClock(NamedTuple):
    epoch_time_s: np.ndarray   # (N,) per-local-epoch compute time
    comm_time_s: np.ndarray    # (N,) per-round download + upload time


def make_client_clock(scfg: ScheduleConfig, n_clients: int, model_bytes: int,
                      rng: np.random.Generator,
                      n_k: Optional[np.ndarray] = None) -> ClientClock:
    """Draw the static per-client timing profile for a run."""
    epoch_t = rng.lognormal(mean=math.log(scfg.epoch_time_mean_s),
                            sigma=scfg.epoch_time_sigma,
                            size=n_clients).astype(np.float64)
    if scfg.data_scaled and n_k is not None:
        n_k = np.asarray(n_k, np.float64)
        epoch_t = epoch_t * (n_k / max(n_k.mean(), 1.0))
    comm_t = np.full(n_clients,
                     model_bytes / scfg.downlink_bytes_per_s
                     + model_bytes / scfg.uplink_bytes_per_s, np.float64)
    return ClientClock(epoch_time_s=epoch_t, comm_time_s=comm_t)


def deadline_epochs(clock: ClientClock, scfg: ScheduleConfig,
                    sel: np.ndarray, max_epochs: int) -> np.ndarray:
    """(M,) int32 local epochs each selected client completes before tau.

    A client whose transfer alone exceeds the deadline contributes 0 epochs
    (it uploads the unchanged broadcast model — pure noise-floor weight).
    """
    sel = np.asarray(sel)
    budget = scfg.deadline_s - clock.comm_time_s[sel]
    e = np.floor(budget / np.maximum(clock.epoch_time_s[sel], 1e-12))
    return np.clip(e, 0, max_epochs).astype(np.int32)


def round_duration_s(clock: ClientClock, scfg: ScheduleConfig,
                     sel: np.ndarray, epochs_k: np.ndarray) -> float:
    """Simulated duration of one round: the slowest selected client, capped
    at the deadline (the server proceeds at tau regardless)."""
    sel = np.asarray(sel)
    t = clock.comm_time_s[sel] + np.asarray(epochs_k) * clock.epoch_time_s[sel]
    if t.size == 0:
        return 0.0
    return float(np.minimum(t, scfg.deadline_s).max())


@dataclasses.dataclass
class VirtualClock:
    """Accumulates simulated seconds across rounds."""
    now_s: float = 0.0

    def advance(self, dt_s: float) -> float:
        self.now_s += float(dt_s)
        return self.now_s


# ---------------------------------------------------------------------------
# Whole-run epoch tables for the scan engine (DESIGN.md §11).
#
# The loop/batched engines derive each round's E_k on the host *after*
# selection; the scan engine selects on-device inside one compiled program,
# so every round's per-client budget must exist up front as a (T, N) int32
# operand the trace gathers rows from.
# ---------------------------------------------------------------------------

def deadline_epochs_table(clock: ClientClock, scfg: ScheduleConfig,
                          rounds: int, max_epochs: int) -> np.ndarray:
    """(T, N) int32 deadline-derived budgets — the timing profile is static,
    so every round repeats the same row (exactly `deadline_epochs` for every
    client, keeping scan/batched/loop engines bit-identical)."""
    n = clock.epoch_time_s.shape[0]
    row = deadline_epochs(clock, scfg, np.arange(n), max_epochs)
    return np.tile(row, (rounds, 1))


def eval_mask(rounds: int, eval_every: int) -> np.ndarray:
    """(T,) bool eval table: evaluate after round t iff the mask is set.

    THE single definition of the eval cadence (DESIGN.md §13): round t
    evaluates when ``(t + 1) % eval_every == 0``, and the final round
    always evaluates — so ``eval_every > rounds`` yields exactly one eval.
    Every engine consumes this table instead of re-deriving the predicate;
    under the replica vmap the stacked ``(R, T)`` rows give each replica
    its own cadence.
    """
    if eval_every < 1:
        raise ValueError(f"eval_every must be >= 1, got {eval_every}")
    mask = (np.arange(1, rounds + 1) % eval_every) == 0
    if rounds > 0:
        mask[-1] = True
    return mask


def straggler_epochs_table(rng: np.random.Generator, rounds: int,
                           n_clients: int, straggler_ids, max_epochs: int
                           ) -> np.ndarray:
    """(T, N) int32 budgets under the paper's random-straggler model:
    straggler k completes E_tk ~ U{1..E} in round t, everyone else E.

    The table fills (round-major, client id ascending) from one vectorized
    draw — a fresh stream, NOT the legacy engines' lazily-consumed
    per-selection draws, which cannot be replayed once selection happens
    on-device.  With straggler_frac > 0 the scan engine is therefore
    distribution-identical but not stream-identical to loop/batched
    (DESIGN.md §11)."""
    table = np.full((rounds, n_clients), max_epochs, np.int32)
    ids = sorted(int(k) for k in straggler_ids)
    if ids:
        table[:, ids] = rng.integers(1, max_epochs + 1,
                                     size=(rounds, len(ids)))
    return table
