"""The fused round engine and the whole-run scan body (counterpart of
`repro/engine/round_engine.py`: `RoundSpec`, `RoundOutput`,
`make_round_step`, `RoundEngine`, `ScanSpec`, `SegmentCarry`,
`SegmentOutput`, `ScanRunOutput`, `make_segment_step`, `make_run_scan`).

The loop engine issues, per round, M client updates, a GTG-Shapley pass and
an average from the server loop.  `round_step` runs the whole round for the
cohort at once, in the reference's order:

  1. `cohort_update`: cohort gather + the M local trainings as one batch;
  2. `delta_codec_roundtrip` when `upload_codec != "identity"`;
  3. the streaming (`prefix_avg`) or dense (`weighted_avg`) Shapley pass;
  4. `weighted_average(stacked, normalized_weights(n_k))`.

The reference's round key becomes the round's draws (minibatch rows, noise
leaves, walks), made by `RunDraws.round` before the round, so every engine
makes the same run.  The hardened round (`spec.faults`, `spec.quarantine`)
runs `harden_cohort` after the codec on the cohort's (M,) fault codes,
walks the Shapley stage with the masked weights `n_k_sv`, zeroes the SVs
of quarantined rows and aggregates with `masked_average`; it is tensor
code throughout, so the captured round holds it too.

engine="scan" (`engine/scan_engine.py`) runs the same round with the
selection and the valuation update around it (`_make_scan_body`), on
tensors that never leave the card: the selector state, the round counter
and the eval slot are device tensors, the cohort ids stay on the card
(`cohort_gather`'s device-id entry), the straggler budgets are a device
gather with a static trip count, the Shapley truncation is a device select
and the kernel wrappers read nothing back.  `make_segment_step` keeps the
carry and the per-round outputs in static device buffers and, on the card,
captures one round as a CUDA graph (and the eval as a second one), then
replays it round after round with no host sync in between; on the CPU the
same functions run eagerly in a Python loop.  Capture needs the round's
inputs in static buffers, a warm-up before it and no host work in the
body: a segment's draws are staged on the card before its replays and each
round gathers its own by the device round counter.  A grid partition's
replicas are one step of several runs, their S round bodies captured in
sequence as one graph (`repro_torch.grid`).
"""
from __future__ import annotations

import contextlib
import time
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch import kernels
from repro_torch.core.aggregation import normalized_weights, weighted_average
from repro_torch.core.selection import (
    DeviceSelectionContext, DeviceSelectorState, SelectionDraw,
    device_select_any, device_update_any,
)
from repro_torch.core.shapley_batched import (
    SHAPLEY_IMPLS, gtg_shapley_batched, gtg_shapley_streaming,
    make_batched_mlp_utility, shapley_stage,
)
from repro_torch.engine.batch_client import cohort_update
from repro_torch.faults import harden_cohort, masked_average
from repro_torch.federated.client import ClientConfig, local_loss
from repro_torch.federated.compression import codec_nbytes
from repro_torch.federated.draws import (
    DrawPlan, RoundDraws, RunDraws, minibatch_rows, round_at,
)
from repro_torch.kernels.cohort_gather.kernel import error_word
from repro_torch.kernels.delta_codec import delta_codec_roundtrip
from repro_torch.models.mlp_cnn import ClassifierModel
from repro_torch.telemetry import profile, trace
from repro_torch.telemetry.trace import named_stage
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
    # fault injection (a FaultSpec) and the quarantine screen: both static;
    # off, the round holds no hardening op at all
    faults: Optional[Any] = None
    quarantine: bool = False
    quarantine_z: float = 8.0


class RoundOutput(NamedTuple):
    params: Params             # w^{t+1}
    sv: torch.Tensor           # (M,) this round's GTG-SV (zeros if unused)
    utility_evals: Any         # int, or () int32 tensor in a captured round
    sv_truncated: Any          # bool, or () bool tensor: truncation fired
    ok: torch.Tensor           # (M,) bool: survived the faults and screen
    quarantined: Any           # () int32 quarantined rows (0 unhardened)
    shapley_time_s: float = 0.0   # the port's own: synchronised SV seconds


def make_round_step(model: ClassifierModel, ccfg: ClientConfig,
                    spec: RoundSpec, *, capturable: bool = False,
                    n_steps: Optional[int] = None
                    ) -> Callable[..., RoundOutput]:
    """Build the round function:

        (params, xs_all, ys_all, nv_all, sigma_all, x_val, y_val, sel,
         epochs_k, idx, noise, walks, fault_codes=None, *, error=None)
        -> RoundOutput

    idx (M, E*B, batch) and noise (leaves (M, *shape)) are the cohort's
    draws; `walks` is the (R, M) walk tensor of the streaming and dense
    estimators, or the serial estimator's batch callable; `fault_codes`
    the cohort's (M,) fault codes on the device (read only by a hardened
    round; None reads as no fault).  The host engines pass sel and
    epochs_k as host ints.

    `capturable=True` builds the round a CUDA graph can hold: sel and
    epochs_k are device tensors, the local training runs the static
    `n_steps`, the gather reports a bad id into the word `error`, the
    Shapley stage is neither timed nor skipped (a truncated round computes
    its walk and zeroes it on the device), the walks and validation labels
    come checked, and the stats come back as () device tensors.
    """
    if spec.shapley_impl not in SHAPLEY_IMPLS:
        raise ValueError(f"unknown shapley_impl {spec.shapley_impl!r}; "
                         f"options: {SHAPLEY_IMPLS}")
    if spec.faults is not None:
        spec.faults.validate()
    hardened = spec.faults is not None or spec.quarantine
    if capturable and spec.shapley_impl == "serial":
        raise NotImplementedError(
            "shapley_impl='serial' under engine='scan' is not ported yet: "
            "its within-round truncation is a host loop; it comes with a "
            "later slice of the PyTorch port (see ROADMAP.md)")

    def shapley(stacked, n_k_sel, params, x_val, y_val, walks):
        def utility_fn(p):  # U(w) = -L(w; D_val), as in the loop engine
            with torch.no_grad():
                return -model.loss(p, x_val, y_val)

        batched = make_batched_mlp_utility(model, x_val, y_val,
                                           checked=capturable)
        if not capturable:
            return shapley_stage(
                spec.shapley_impl, stacked, n_k_sel, params, utility_fn,
                batched, walks, eps=spec.shapley_eps,
                max_iters=spec.shapley_max_iters, sv_chunk=spec.sv_chunk)
        if spec.shapley_impl == "streaming":
            sv, stats = gtg_shapley_streaming(
                stacked, n_k_sel, params, utility_fn, batched, walks,
                eps=spec.shapley_eps, sv_chunk=spec.sv_chunk,
                skip_truncated=False, checked=True)
        else:
            sv, stats = gtg_shapley_batched(
                stacked, n_k_sel, params, utility_fn, batched, walks,
                eps=spec.shapley_eps, skip_truncated=False)
        return sv, stats, 0.0

    def round_step(params, xs_all, ys_all, nv_all, sigma_all, x_val, y_val,
                   sel, epochs_k, idx, noise, walks, fault_codes=None, *,
                   error=None) -> RoundOutput:
        # the named stages are profiler / NVTX ranges (metadata only), or
        # graph boundaries of a stage-timed capture (telemetry.trace)
        with named_stage("train"):
            stacked, n_k_sel = cohort_update(
                model, ccfg, params, xs_all, ys_all, nv_all, sigma_all, sel,
                epochs_k, idx, noise, n_steps=n_steps, error=error)
            if spec.upload_codec != "identity":
                with named_stage("codec"):
                    stacked = delta_codec_roundtrip(stacked, params,
                                                    spec.upload_codec)

        m = sel.shape[0]
        device = n_k_sel.device
        n_k_sv = n_k_sel
        if hardened:
            # inject the coded faults into the decoded cohort, screen it,
            # and mask the failures out of everything downstream
            if fault_codes is None:
                fault_codes = torch.zeros((m,), dtype=torch.int64,
                                          device=device)
            with named_stage("quarantine"):
                h = harden_cohort(stacked, params, n_k_sel, fault_codes,
                                  faults=spec.faults,
                                  quarantine=spec.quarantine,
                                  z=spec.quarantine_z)
            stacked, n_k_sv = h.stacked, h.n_k_sv
        sv = torch.zeros((m,), device=device)
        evals, truncated, sv_s = 0, False, 0.0
        if capturable:
            evals = torch.zeros((), dtype=torch.int32, device=device)
            truncated = torch.zeros((), dtype=torch.bool, device=device)
        if spec.needs_sv:
            with named_stage("shapley"):
                sv, stats, sv_s = shapley(stacked, n_k_sv, params, x_val,
                                          y_val, walks)
                evals, truncated = stats.utility_evals, stats.truncated_round
                if hardened:
                    # quarantined rows walked as w_prev at 2^-100: no credit
                    sv = torch.where(h.ok, sv, 0.0)

        with named_stage("aggregate"):
            if hardened:
                return RoundOutput(
                    masked_average(stacked, h.n_k_agg, h.ok, params), sv,
                    evals, truncated, h.ok, h.quarantined, sv_s)
            with torch.no_grad():
                new_params = weighted_average(stacked,
                                              normalized_weights(n_k_sel))
        quarantined = (torch.zeros((), dtype=torch.int32, device=device)
                       if capturable else 0)
        return RoundOutput(new_params, sv, evals, truncated,
                           torch.ones((m,), dtype=torch.bool, device=device),
                           quarantined, sv_s)

    return round_step


def round_plan(spec: RoundSpec, ccfg: ClientConfig, selectors: tuple,
               n_clients: int, m: int, params: Params,
               n_valid: np.ndarray) -> DrawPlan:
    """The draws one round of `spec` takes under the SelectorSpecs
    `selectors`.  The serial estimator draws its walks as it goes
    (`RunDraws.perm_batches`), so its plan has none."""
    walked = spec.needs_sv and spec.shapley_impl != "serial"
    return DrawPlan(
        selection=tuple(sorted({k for sp in selectors
                                for k in sp.selection_draws})),
        n_clients=n_clients, m=m,
        n_steps=ccfg.epochs * ccfg.batches_per_epoch,
        batch_size=ccfg.batch_size,
        shapes=tuple(tuple(x.shape) for x in tree_leaves(params)),
        n_perms=spec.shapley_max_iters if walked else 0,
        n_valid=tuple(int(n) for n in n_valid))


class RoundEngine:
    """Owns the round function plus the per-run constant operands.

    One instance per `run_federated` call: the padded client stacks,
    privacy sigmas and validation split are bound once; per round only
    (params, sel, epochs_k) and the round's draws, on the device, come in
    (`step` makes round t's draws itself when none are given).
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

    def step(self, params: Params, sel, epochs_k, t: int,
             rd: Optional[RoundDraws] = None,
             fault_codes=None) -> RoundOutput:
        """Execute one full communication round as one call.  `rd` holds
        round t's draws, on the run's device; `fault_codes` the cohort's
        (M,) host fault codes (None: no fault)."""
        sel = np.asarray(sel, np.int64)
        m = len(sel)
        nv_all = self._operands[2]
        if rd is None:
            rd = self.draws.round(t, round_plan(
                self.spec, self.ccfg, (), len(self._nv_host), m, params,
                self._nv_host)).to(nv_all.device)
        idx = minibatch_rows(rd.rows, torch.as_tensor(sel,
                                                      device=nv_all.device),
                             nv_all)
        spec, walks = self.spec, None
        if spec.needs_sv:
            walks = (self.draws.perm_batches(t, m)
                     if spec.shapley_impl == "serial" else rd.walks)
        codes = (None if fault_codes is None else torch.as_tensor(
            np.asarray(fault_codes, np.int64), device=nv_all.device))
        return self._step(params, *self._operands, sel,
                          np.asarray(epochs_k), idx, rd.noise, walks, codes)

    def upload_nbytes_per_client(self, params: Params) -> int:
        """Wire bytes of one client upload under this spec's codec."""
        return codec_nbytes(self.spec.upload_codec, params)


# --------------------------------------------------------------------------
# the whole-run scan: one round's body, segments of captured replays
# --------------------------------------------------------------------------

class ScanSpec(NamedTuple):
    """Static config of a whole-run scan.

    `selectors` is a tuple of SelectorSpecs: length 1 selects statically;
    longer tuples switch by a device `strategy_id` (all entries share
    n_clients / m).  `rounds_per_segment` K > 0 runs the run as segments
    of K rounds whose carry the host reads back between them; 0 is one
    segment of `rounds`.  The eval cadence is the (T,) host table
    `ScanOperands.eval_table`, not part of the spec.  `live_tap` plants
    the telemetry tap in the round: each round's record is copied into a
    pinned host ring that a host thread reads as the rounds land
    (`telemetry.trace.attach_live_tap`); it changes no output.
    """
    round: RoundSpec
    selectors: tuple            # tuple[SelectorSpec, ...]
    rounds: int                 # T: total rounds of the run
    rounds_per_segment: int = 0  # K: rounds a segment (0 = whole run)
    live_tap: bool = False


class ScanOperands(NamedTuple):
    """A scan run's constant operands, on its device (the eval table on
    the host, where it picks which captured graph a round replays)."""
    xs_all: torch.Tensor        # (N, cap, ...) padded client data
    ys_all: torch.Tensor        # (N, cap) int64
    nv_all: torch.Tensor        # (N,) int64
    sigma_all: torch.Tensor     # (N,) float32
    x_val: torch.Tensor
    y_val: torch.Tensor         # range-checked once, at set-up
    x_test: torch.Tensor
    y_test: torch.Tensor
    fractions: torch.Tensor     # (N,) float32
    epochs_table: torch.Tensor  # (T, N) int64 local-epoch budgets
    fault_table: torch.Tensor   # (T, N) int64 fault codes, range-checked
    d_sched: torch.Tensor       # (T,) int64 Power-of-Choice candidates
    eval_table: np.ndarray      # (T,) bool, host
    strategy_id: torch.Tensor   # () int64 index into spec.selectors
    n_steps: int                # max(epochs_table) * B: the trip count


class SegmentCarry(NamedTuple):
    """What a scan run threads between rounds, and so what crosses a
    segment boundary.  The reference's `key` has no counterpart: the
    draws of round t are `RunDraws.round(t, ...)`."""
    params: Params
    sel_state: DeviceSelectorState
    eval_slot: torch.Tensor     # () int64 evals done so far


class SegmentOutput(NamedTuple):
    """One segment's carry-out plus its stacked (K, ...) round outputs."""
    carry: SegmentCarry
    selections: torch.Tensor    # (K, M) int64
    epochs: torch.Tensor        # (K, M) int64
    sv: torch.Tensor            # (K, M)
    utility_evals: torch.Tensor  # (K,) int32
    sv_truncated: torch.Tensor  # (K,) bool
    test_acc: torch.Tensor      # (K,) NaN on non-eval rounds
    val_loss: torch.Tensor      # (K,) NaN on non-eval rounds
    granted: torch.Tensor       # (K,) int64 active (granted) cohort size
    quarantined: torch.Tensor   # (K,) int32 (zeros without faults)


class ScanRunOutput(NamedTuple):
    params: Params              # w^T
    sel_state: DeviceSelectorState
    selections: torch.Tensor    # (T, M)
    epochs: torch.Tensor        # (T, M) E_k actually granted
    sv: torch.Tensor            # (T, M) per-round GTG-SV (zeros if unused)
    utility_evals: torch.Tensor  # (T,)
    sv_truncated: torch.Tensor  # (T,)
    test_acc: torch.Tensor      # (T,) NaN on non-eval rounds
    val_loss: torch.Tensor      # (T,) NaN on non-eval rounds
    granted: torch.Tensor       # (T,)
    quarantined: torch.Tensor   # (T,)
    eval_count: torch.Tensor    # () evals performed


_OUTPUTS = ("selections", "epochs", "sv", "utility_evals", "sv_truncated",
            "granted", "quarantined")


def _complete_draw(need: set, m: int, draw: SelectionDraw,
                   fractions: torch.Tensor) -> SelectionDraw:
    """The selection draw with zeros for what another strategy of a
    partition's switch reads (`need`) and this run does not draw: a
    replica draws what its solo run draws, and the switch drops the other
    branches' picks.  A solo run draws all it needs: nothing is added."""
    choice, gumbel = draw
    if "choice" in need and choice is None:
        choice = torch.zeros((m,), dtype=torch.int64,
                             device=fractions.device)
    if "gumbel" in need and gumbel is None:
        gumbel = torch.zeros_like(fractions)
    return SelectionDraw(choice, gumbel)


def _make_scan_body(model: ClassifierModel, ccfg: ClientConfig,
                    spec: ScanSpec, n_steps: int):
    """The per-round body that `make_segment_step` captures: selection,
    the straggler E_k gather, training, codec, GTG-Shapley, the valuation
    update; and the eval, apart, since the host picks the rounds it runs
    on.  Everything is tensors in, tensors out, with no host read."""
    round_step = make_round_step(model, ccfg, spec.round, capturable=True,
                                 n_steps=n_steps)
    uses_losses = any(sp.uses_local_losses for sp in spec.selectors)
    needs_sv = spec.round.needs_sv
    draws_needed = {k for sp in spec.selectors for k in sp.selection_draws}
    m = spec.selectors[0].m

    def bind(ops: ScanOperands):
        def body(carry: SegmentCarry, per_round, error):
            params, sstate, eval_slot = carry
            epochs_row, fault_row, d_t, rd = per_round
            if uses_losses:   # Power-of-Choice ranks clients by w^t loss
                losses = local_loss(model, params, ops.xs_all, ops.ys_all,
                                    ops.nv_all)
            else:
                losses = torch.zeros_like(ops.fractions)
            with named_stage("select"):
                ctx = DeviceSelectionContext(data_fractions=ops.fractions,
                                             local_losses=losses, poc_d=d_t)
                sel, sstate = device_select_any(
                    spec.selectors, ops.strategy_id, sstate, ctx,
                    _complete_draw(draws_needed, m, rd.selection,
                                   ops.fractions))
                epochs_k = epochs_row.index_select(0, sel)
                codes_k = fault_row.index_select(0, sel)
                # active mask at select time: dropout strategies freeze it
                active_sel = sstate.active.index_select(0, sel)
                idx = minibatch_rows(rd.rows, sel, ops.nv_all)
            out = round_step(params, ops.xs_all, ops.ys_all, ops.nv_all,
                             ops.sigma_all, ops.x_val, ops.y_val, sel,
                             epochs_k, idx, rd.noise, rd.walks, codes_k,
                             error=error)
            # the granted cohort: active under the strategy's mask and not
            # refused by a fault screen (`ok` is all true without faults)
            granted = torch.sum(active_sel & out.ok)
            sstate = device_update_any(spec.selectors, ops.strategy_id,
                                       sstate, sel,
                                       out.sv if needs_sv else None)
            ys = {"selections": sel, "epochs": epochs_k, "sv": out.sv,
                  "utility_evals": out.utility_evals,
                  "sv_truncated": out.sv_truncated, "granted": granted,
                  "quarantined": out.quarantined}
            return SegmentCarry(out.params, sstate, eval_slot), ys

        def evaluate(params):
            with torch.no_grad():
                return (model.accuracy(params, ops.x_test, ops.y_test),
                        model.loss(params, ops.x_val, ops.y_val))

        return body, evaluate

    return bind


def _copy_tree(dst, src) -> None:
    """Copy a (nested) tuple / dict of tensors into one of the same shape."""
    if isinstance(dst, dict):
        for k in dst:
            _copy_tree(dst[k], src[k])
    elif isinstance(dst, tuple):
        for a, b in zip(dst, src):
            _copy_tree(a, b)
    else:
        dst.copy_(src)


def _clone_tree(x):
    if isinstance(x, dict):
        return {k: _clone_tree(v) for k, v in x.items()}
    if isinstance(x, tuple):
        parts = [_clone_tree(v) for v in x]
        return type(x)(*parts) if hasattr(x, "_fields") else tuple(parts)
    return x.clone() if x is not None else None


def _buffers_like(rd: RoundDraws, k: int, device) -> RoundDraws:
    """Static (K, ...) staging buffers for K rounds of draws shaped `rd`."""
    def make(x):
        return None if x is None else torch.empty((k,) + tuple(x.shape[1:]),
                                                  dtype=x.dtype,
                                                  device=device)
    sel = rd.selection
    return RoundDraws(type(sel)(make(sel.choice), make(sel.gumbel)),
                      make(rd.rows), [make(x) for x in rd.noise],
                      make(rd.walks))


def _stage(dst: RoundDraws, src: RoundDraws, device) -> None:
    """Copy a segment's host draws into the head of the staging buffers:
    from pinned memory without waiting on the card."""
    pin = device.type == "cuda"

    def copy(d, s):
        if d is not None:
            if pin:
                s = s.pin_memory()
            d[: s.shape[0]].copy_(s, non_blocking=pin)

    copy(dst.selection.choice, src.selection.choice)
    copy(dst.selection.gumbel, src.selection.gumbel)
    copy(dst.rows, src.rows)
    for d, s in zip(dst.noise, src.noise):
        copy(d, s)
    copy(dst.walks, src.walks)


class _Replica:
    """One scan run's static device buffers (the carry, the staged draws
    and the per-round outputs) and the two functions a graph captures,
    `round` and `eval`, over its own `ScanOperands`.  `SegmentStep`
    drives one or more of them."""

    def __init__(self, model, ccfg, spec: ScanSpec, ops: ScanOperands):
        self.spec, self.ops = spec, ops
        self.k = spec.rounds_per_segment or spec.rounds
        self.device = ops.nv_all.device
        self.body, self.evaluate = _make_scan_body(
            model, ccfg, spec, ops.n_steps)(ops)
        self.error = error_word(self.device)
        self.eval_table = None      # (T,) bool device table when gated
        self.carry = None
        self.tap = (trace.TapRing(self.k, spec.selectors[0].m, self.device)
                    if spec.live_tap else None)

    def _allocate(self, carry: SegmentCarry, draws_seg: RoundDraws) -> None:
        k, dev = self.k, self.device
        m = self.spec.selectors[0].m
        self.carry = _clone_tree(carry)
        self.t0 = torch.zeros((1,), dtype=torch.int64, device=dev)
        self.staged = _buffers_like(draws_seg, k, dev)
        nan = (lambda: torch.full((k,), float("nan"), device=dev))
        self.outs = {
            "selections": torch.zeros((k, m), dtype=torch.int64, device=dev),
            "epochs": torch.zeros((k, m), dtype=torch.int64, device=dev),
            "sv": torch.zeros((k, m), device=dev),
            "utility_evals": torch.zeros((k,), dtype=torch.int32, device=dev),
            "sv_truncated": torch.zeros((k,), dtype=torch.bool, device=dev),
            "granted": torch.zeros((k,), dtype=torch.int64, device=dev),
            "quarantined": torch.zeros((k,), dtype=torch.int32, device=dev),
            "test_acc": nan(), "val_loss": nan()}

    # the two captured functions: all their inputs and outputs are static
    def round(self) -> None:
        ops, carry = self.ops, self.carry
        t = carry.sel_state.round.reshape(1)
        k = t - self.t0
        per_round = (ops.epochs_table.index_select(0, t)[0],
                     ops.fault_table.index_select(0, t)[0],
                     ops.d_sched.index_select(0, t)[0],
                     round_at(self.staged, k))
        new, ys = self.body(carry, per_round, self.error)
        for name in _OUTPUTS:
            self.outs[name].index_copy_(0, k, ys[name][None].to(
                self.outs[name].dtype))
        if self.tap is not None:
            trace.attach_live_tap(self.tap, k, t, ops.strategy_id,
                                  ys["selections"], ys["sv"],
                                  ys["utility_evals"], ys["sv_truncated"])
        _copy_tree(carry, new)

    def eval(self) -> None:
        """The eval after the round just run.  Gated by `eval_table`, it
        writes NaN, and leaves the eval slot, where the table is not set
        for that round."""
        carry = self.carry
        t = carry.sel_state.round.reshape(1) - 1
        k = t - self.t0
        with named_stage("eval"):
            acc, vloss = self.evaluate(carry.params)
        acc, vloss = acc.reshape(1), vloss.reshape(1)
        if self.eval_table is not None:
            do = self.eval_table.index_select(0, t)
            nan = torch.full_like(acc, float("nan"))
            acc, vloss = torch.where(do, acc, nan), torch.where(do, vloss, nan)
        self.outs["test_acc"].index_copy_(0, k, acc)
        self.outs["val_loss"].index_copy_(0, k, vloss)
        carry.eval_slot.add_(1 if self.eval_table is None
                             else do[0].to(carry.eval_slot.dtype))

    def load(self, carry: SegmentCarry, t0: int,
             draws_seg: RoundDraws) -> None:
        """Put the carry, t0 and the segment's host draws into the static
        buffers."""
        if self.carry is None:
            self._allocate(carry, draws_seg)
        n = draws_seg.rows.shape[0]
        if n > self.k or t0 + n > self.spec.rounds:
            raise ValueError(f"a segment of {n} rounds from round {t0}: at "
                             f"most {self.k} a segment, {self.spec.rounds} "
                             "in all")
        _copy_tree(self.carry, carry)
        self.t0.fill_(t0)
        _stage(self.staged, draws_seg, self.device)

    def clear(self) -> None:
        # after the warm-up's round and eval: a round without an eval reads
        # NaN, and the tap ring holds no round yet
        self.outs["test_acc"].fill_(float("nan"))
        self.outs["val_loss"].fill_(float("nan"))
        if self.tap is not None:
            self.tap.clear()

    def output(self, n: int) -> SegmentOutput:
        """The carry and the first n rounds' outputs, as device copies."""
        o = self.outs
        return SegmentOutput(
            _clone_tree(self.carry), *(o[k][:n].clone() for k in (
                "selections", "epochs", "sv", "utility_evals",
                "sv_truncated", "test_acc", "val_loss", "granted",
                "quarantined")))


class SegmentStep:
    """`make_segment_step`'s callable: runs rounds [t0, t0 + k) of one or
    more scan runs in lock-step, from their carries, on static device
    buffers.  A solo scan is one run; a grid partition's S replicas are S
    runs over the partition's strategy tuple `spec.selectors`, each with
    the `ScanOperands` its solo run builds and its strategy's index in
    `ops.strategy_id`, so each makes its solo run bit for bit.

    On a CUDA device the first call warms every run's round and eval up on
    a side stream, puts the carries back and captures the S round bodies
    in sequence as one CUDA graph (one pool: the transients of one body
    are reused by the next) and the S evals as a second.  The host replays
    the round graph once a round and the eval graph after the rounds where
    any run's eval table is set; a run whose table is not that union is
    gated by its own (T,) device table.  Between replays nothing syncs the
    host (`torch.cuda.set_sync_debug_mode("error")` is on around them).  A
    failed capture raises, its graphs reset: nothing runs eagerly on the
    card.  On the CPU the same functions run eagerly.  Kernel launches
    made while a graph was captured are counted in `graph_launches` (a
    replay launches them again uncounted), and `replays` counts each
    graph's replays (or eager runs on the CPU).

    Telemetry options, none of which changes an output bit:
    `stage_events=True` captures the round as one graph a named stage
    (`telemetry.trace.StageCapture`) and replays each piece between CUDA
    timing events, so `stage_seconds()` gives each stage's device time
    over the replays (on the CPU it is the plain path); `count_flops=True`
    counts the matrix-product FLOPs of the round and of the eval in the
    eager run the step makes anyway (the warm-up on a card, the first
    round and eval on the CPU) into `flops`; with `spec.live_tap` each run
    has a `TapRing` (`tap_rings`).

        step.stage(carries, t0, draws_segs); step.replay(t0, n);
        step.output(n) -> [SegmentOutput, ...]
    """

    def __init__(self, model, ccfg, spec: ScanSpec, ops_list: list, *,
                 stage_events: bool = False, count_flops: bool = False):
        self.runs = [_Replica(model, ccfg, spec, ops) for ops in ops_list]
        self.spec, self.k = spec, self.runs[0].k
        self.device = self.runs[0].device
        self.eval_any = np.any([ops.eval_table for ops in ops_list], axis=0)
        for run, ops in zip(self.runs, ops_list):
            if not np.array_equal(ops.eval_table, self.eval_any):
                run.eval_table = torch.as_tensor(ops.eval_table,
                                                 device=self.device)
        self.graphs = None
        self.graph_launches = {"round": {}, "eval": {}}
        self.replays = {"round": 0, "eval": 0}
        self.capture_time_s = 0.0
        cuda = self.device.type == "cuda"
        self.stage_events = stage_events and cuda
        self._timer = trace.StageTimer() if self.stage_events else None
        self.flops = {} if count_flops else None

    @property
    def tap_rings(self) -> list:
        return [run.tap for run in self.runs if run.tap is not None]

    def _round(self) -> None:
        for run in self.runs:
            run.round()

    def _eval(self) -> None:
        for run in self.runs:
            run.eval()

    def _counted(self, name: str, fn) -> None:
        """Run `fn`, under the FLOP counter when `name` is still to count."""
        if self.flops is None or name in self.flops:
            fn()
            return
        with profile.FlopCount() as fc:
            fn()
        self.flops[name] = float(fc.get_total_flops())

    def _capture(self) -> None:
        """Warm both functions up on a side stream, put the carries and
        error words back, capture each as a CUDA graph (the round as one
        graph a stage under `stage_events`).  A capture that raises resets
        the graphs made so far before the error goes on, so their pools are
        released with them."""
        t_start = time.perf_counter()
        fns = {"round": self._round, "eval": self._eval}
        saved = [_clone_tree(run.carry) for run in self.runs]
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            for name, fn in fns.items():
                self._counted(name, fn)
        torch.cuda.current_stream(self.device).wait_stream(side)
        for run, carry in zip(self.runs, saved):
            _copy_tree(run.carry, carry)
            run.error.zero_()
        graphs, launches = {}, {}
        try:
            for name, fn in fns.items():
                before = dict(kernels.LAUNCHES)
                if name == "round" and self.stage_events:
                    graphs[name] = trace.StageCapture()
                    with torch.cuda.stream(side):
                        graphs[name].run(fn)
                else:
                    graphs[name] = torch.cuda.CUDAGraph()
                    with torch.cuda.graph(graphs[name]):
                        fn()
                launches[name] = {n: kernels.LAUNCHES[n] - before[n]
                                  for n in before}
            torch.cuda.synchronize(self.device)
        except BaseException:
            for g in graphs.values():
                g.reset()
            raise
        self.graphs, self.graph_launches = graphs, launches
        self.capture_time_s = time.perf_counter() - t_start
        trace.add_compile_seconds(self.capture_time_s)

    def stage(self, carries: list, t0: int, draws_segs: list) -> None:
        """Each run's carry, t0 and host draws (checked, one leading round
        axis) into its static buffers; capture on the first call on the
        card."""
        for run, carry, draws_seg in zip(self.runs, carries, draws_segs):
            run.load(carry, t0, draws_seg)
        if self.device.type == "cuda" and self.graphs is None:
            self._capture()
        for run in self.runs:
            run.clear()

    def replay(self, t0: int, n: int) -> None:
        """Run rounds [t0, t0 + n) of the staged segment for every run,
        the eval after the rounds some run evaluates."""
        cuda = self.device.type == "cuda"
        guard = (_sync_debug_error() if cuda else contextlib.nullcontext())
        with guard:
            for t in range(t0, t0 + n):
                self._run("round")
                if self.eval_any[t]:
                    self._run("eval")

    def _run(self, name: str) -> None:
        self.replays[name] += 1
        if self.graphs is None:
            self._counted(name, self._round if name == "round"
                          else self._eval)
        elif self._timer is None:
            self.graphs[name].replay()
        elif name == "round":
            self._timer.replay(self.graphs[name].pieces)
        else:
            self._timer.replay([("eval", self.graphs[name])])

    def stage_seconds(self) -> dict:
        """Each stage's device seconds over the replays since the last call
        (after the work synchronised); empty without `stage_events`."""
        return self._timer.totals() if self._timer is not None else {}

    def output(self, n: int) -> list:
        """Each run's carry and first n rounds' outputs, device copies."""
        return [run.output(n) for run in self.runs]

    @property
    def errors(self) -> list:
        """The runs' cohort-gather error words (read once a segment)."""
        return [run.error for run in self.runs]

    def __call__(self, carries: list, t0: int, draws_segs: list) -> list:
        n = draws_segs[0].rows.shape[0]
        self.stage(carries, t0, draws_segs)
        self.replay(t0, n)
        return self.output(n)


@contextlib.contextmanager
def _sync_debug_error():
    previous = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(previous)


def make_segment_step(model: ClassifierModel, ccfg: ClientConfig,
                      spec: ScanSpec, ops, **options) -> SegmentStep:
    """The K-round segment step over the operands `ops` (one run's
    `ScanOperands`, or a list of runs' advanced together):

        step(carries, t0, draws_segs) -> [SegmentOutput, ...]

    one entry a run: its SegmentCarry, and rounds [t0, t0 + k) of its
    draws on the host (k <= K = spec.rounds_per_segment or spec.rounds),
    stacked on a leading round axis, their walks already range-checked.
    Chaining segments from t0 = 0 reproduces `make_run_scan` bit for bit:
    the same captured round, the same carry, the same draws.  `options`
    are SegmentStep's telemetry keywords."""
    return SegmentStep(model, ccfg, spec,
                       ops if isinstance(ops, list) else [ops], **options)


def make_run_scan(model: ClassifierModel, ccfg: ClientConfig,
                  spec: ScanSpec, ops: ScanOperands
                  ) -> Callable[..., ScanRunOutput]:
    """The whole run as one segment of T rounds:

        run_scan(params, sel_state, draws_all) -> ScanRunOutput

    with `draws_all` the run's T rounds of draws, stacked."""
    whole = spec._replace(rounds_per_segment=0)
    step = make_segment_step(model, ccfg, whole, ops)

    def run_scan(params, sel_state, draws_all: RoundDraws) -> ScanRunOutput:
        zero = torch.zeros((), dtype=torch.int64, device=ops.nv_all.device)
        (out,) = step([SegmentCarry(params, sel_state, zero)], 0,
                      [draws_all])
        return ScanRunOutput(out.carry.params, out.carry.sel_state,
                             out.selections, out.epochs, out.sv,
                             out.utility_evals, out.sv_truncated,
                             out.test_acc, out.val_loss, out.granted,
                             out.quarantined, out.carry.eval_slot)

    return run_scan
