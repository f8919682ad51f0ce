"""The fused round engine: one Python call per communication round
(counterpart of `repro/engine/round_engine.py`: `RoundSpec`, `RoundOutput`,
`make_round_step`, `RoundEngine`).

The loop engine issues, per round, M client updates, a GTG-Shapley pass and
an average from the server loop.  `round_step` runs the whole round for the
cohort at once, in the reference's order:

  1. `cohort_update`: cohort gather + the M local trainings as one batch;
  2. `delta_codec_roundtrip` when `upload_codec != "identity"`;
  3. the streaming (`prefix_avg`) or dense (`weighted_avg`) Shapley pass;
  4. `weighted_average(stacked, normalized_weights(n_k))`.

The reference's round key becomes the round's draws (minibatch tables,
noise leaves, walks), which `RoundEngine.step` takes from a `RunDraws` in
the loop engine's order, so the two engines make the same run.  The
hardened round (faults, quarantine) comes with the faults slice of the
port, and the scan body (`make_run_scan`, `make_segment_step`) with the
scan-engine slice.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.aggregation import normalized_weights, weighted_average
from repro_torch.core.shapley_batched import (
    SHAPLEY_IMPLS, make_batched_mlp_utility, shapley_stage,
)
from repro_torch.engine.batch_client import cohort_draws, cohort_update
from repro_torch.federated.client import ClientConfig
from repro_torch.federated.compression import codec_nbytes
from repro_torch.federated.draws import RunDraws
from repro_torch.kernels.delta_codec import delta_codec_roundtrip
from repro_torch.models.mlp_cnn import ClassifierModel
from repro_torch.tree import tree_leaves

Params = Any

class RoundSpec(NamedTuple):
    """Static round-execution config (the reference's fields)."""
    needs_sv: bool = False
    shapley_impl: str = "streaming"   # one of SHAPLEY_IMPLS
    shapley_eps: float = 1e-4
    shapley_max_iters: int = 250
    sv_chunk: int = 0
    upload_codec: str = "identity"
    faults: Optional[Any] = None
    quarantine: bool = False


class RoundOutput(NamedTuple):
    params: Params             # w^{t+1}
    sv: torch.Tensor           # (M,) this round's GTG-SV (zeros if unused)
    utility_evals: int
    sv_truncated: bool         # between-round truncation fired
    ok: torch.Tensor           # (M,) bool: every row survives (no faults)
    quarantined: int           # quarantined cohort rows (0 without faults)
    shapley_time_s: float = 0.0   # the port's own: synchronised SV seconds


def make_round_step(model: ClassifierModel, ccfg: ClientConfig,
                    spec: RoundSpec) -> Callable[..., RoundOutput]:
    """Build the round function:

        (params, xs_all, ys_all, nv_all, sigma_all, x_val, y_val, sel,
         epochs_k, idx, noise, walks) -> RoundOutput

    sel holds the cohort's M client ids as host ints, which the cohort
    gather checks on the host; idx (M, E*B, batch) and noise (leaves
    (M, *shape)) are the cohort's draws; `walks` is the (R, M) walk tensor
    of the streaming and dense estimators, or the serial estimator's batch
    callable.
    """
    if spec.shapley_impl not in SHAPLEY_IMPLS:
        raise ValueError(f"unknown shapley_impl {spec.shapley_impl!r}; "
                         f"options: {SHAPLEY_IMPLS}")
    if spec.faults is not None or spec.quarantine:
        raise NotImplementedError(
            "the hardened round (faults, quarantine) is not ported yet: it "
            "comes with the faults/quarantine slice of the PyTorch port "
            "(see ROADMAP.md)")

    def round_step(params, xs_all, ys_all, nv_all, sigma_all, x_val, y_val,
                   sel, epochs_k, idx, noise, walks) -> RoundOutput:
        stacked, n_k_sel = cohort_update(
            model, ccfg, params, xs_all, ys_all, nv_all, sigma_all, sel,
            epochs_k, idx, noise)
        if spec.upload_codec != "identity":
            stacked = delta_codec_roundtrip(stacked, params,
                                            spec.upload_codec)

        m = sel.shape[0]
        device = n_k_sel.device
        sv = torch.zeros((m,), device=device)
        evals, truncated, sv_s = 0, False, 0.0
        if spec.needs_sv:
            def utility_fn(p):  # U(w) = -L(w; D_val), as in the loop engine
                with torch.no_grad():
                    return -model.loss(p, x_val, y_val)

            sv, stats, sv_s = shapley_stage(
                spec.shapley_impl, stacked, n_k_sel, params, utility_fn,
                make_batched_mlp_utility(model, x_val, y_val), walks,
                eps=spec.shapley_eps, max_iters=spec.shapley_max_iters,
                sv_chunk=spec.sv_chunk)
            evals, truncated = stats.utility_evals, stats.truncated_round

        with torch.no_grad():
            new_params = weighted_average(stacked,
                                          normalized_weights(n_k_sel))
        return RoundOutput(new_params, sv, evals, truncated,
                           torch.ones((m,), dtype=torch.bool, device=device),
                           0, sv_s)

    return round_step


class RoundEngine:
    """Owns the round function plus the per-run constant operands.

    One instance per `run_federated` call: the padded client stacks,
    privacy sigmas and validation split are bound once; per round only
    (params, sel, epochs_k, t) come in, and the round's draws are taken
    from `draws` in the loop engine's order.
    """

    def __init__(self, model: ClassifierModel, ccfg: ClientConfig,
                 spec: RoundSpec, xs_all, ys_all, nv_all, sigma_all,
                 x_val, y_val, draws: RunDraws):
        self.spec = spec
        self.ccfg = ccfg
        self.draws = draws
        self._step = make_round_step(model, ccfg, spec)
        device = nv_all.device
        self._operands = (xs_all, ys_all, nv_all,
                          torch.as_tensor(sigma_all, dtype=torch.float32,
                                          device=device), x_val, y_val)
        self._nv_host = nv_all.cpu().numpy()

    def step(self, params: Params, sel, epochs_k, t: int) -> RoundOutput:
        """Execute one full communication round as one call."""
        sel = np.asarray(sel, np.int64)
        m = len(sel)
        device = self._operands[2].device
        idx, noise = cohort_draws(
            self.draws, self.ccfg, t, self._nv_host[sel],
            [tuple(x.shape) for x in tree_leaves(params)], device)
        spec, walks = self.spec, None
        if spec.needs_sv:
            walks = (self.draws.perm_batches(t, m)
                     if spec.shapley_impl == "serial"
                     else self.draws.perms(t, m, spec.shapley_max_iters))
        return self._step(params, *self._operands, sel,
                          np.asarray(epochs_k), idx, noise, walks)

    def upload_nbytes_per_client(self, params: Params) -> int:
        """Wire bytes of one client upload under this spec's codec."""
        return codec_nbytes(self.spec.upload_codec, params)
