"""The federated server loop — GreedyFed Alg. 1 plus all baselines.

Counterpart of `repro/federated/server.py`, engines "loop", "batched" and
"scan".  `run_federated` drives T communication rounds:
  select clients -> ClientUpdate at each -> optional upload codec ->
  GTG-Shapley -> ModelAverage -> cumulative-SV update -> eval.
The loop engine runs the round's steps from this loop, client by client;
the batched engine runs each round as one `RoundEngine.step` call
(`engine/round_engine.py`), with the cohort trained as one batch; the scan
engine runs the whole run on the card with no host sync between rounds,
as CUDA-graph replays of one captured round (`engine/scan_engine.py`).
The six strategies share this loop through a `SelectorSpec` and its
selector state (`repro_torch.core.selection`).

The numpy set-up (`setup_run`) consumes the run's rng in the reference's
order, so a seed gives the same data, partition, stragglers and noise
levels.  Random draws of the rounds come from a `RunDraws`
(`federated/draws.py`), round t's all at once before the round, so the
three engines make the same run.  Faults (`FLConfig.faults`, a
`FaultSpec`) are pre-drawn into a (T, N) code table in `setup_run`; with
them or `quarantine=True` every engine hardens its cohort after the codec
(`repro_torch.faults.harden_cohort`).  `run_federated_replicated` runs
seeds of one config together (`engine/replicated.py`) or, under the scan
engine, a strategies x seeds grid (`repro_torch.grid.run_grid`).  A
`telemetry=` sink (`repro_torch.telemetry.Telemetry`) streams the
reference's events: `run_start`, per round `round_metrics` and `eval`,
`compile` and `run_end`.  Parts of the reference that later slices of the
port bring raise `NotImplementedError` naming that slice.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.aggregation import (
    normalized_weights, tree_stack, weighted_average,
)
from repro_torch.core.selection import (
    DeviceSelectionContext, DeviceSelectorState, SelectorSpec,
    device_select, device_update, init_device_state, make_selector_spec,
    poc_d_schedule,
)
from repro_torch.federated.draws import (
    DrawPlan, RunDraws, TorchDraws, minibatch_rows,
)
from repro_torch.core.shapley_batched import (
    SHAPLEY_IMPLS, make_batched_mlp_utility, shapley_stage,
)
from repro_torch.data.synth import SynthDataset, make_dataset
from repro_torch.device import resolve_device, synchronize
from repro_torch.engine.schedule import (
    ScheduleConfig, VirtualClock, deadline_epochs, eval_mask,
    make_client_clock, round_duration_s, straggler_epochs_table,
)
from repro_torch.faults import (
    FaultSpec, draw_fault_table, harden_cohort, masked_average,
)
from repro_torch.federated.client import ClientConfig, client_update, local_loss
from repro_torch.federated.compression import compress_update
from repro_torch.federated.partition import (
    client_cap, dirichlet_partition, padded_x_block, padded_y_block,
    power_law_fractions, valid_counts,
)
from repro_torch.models.mlp_cnn import ClassifierModel, make_classifier
from repro_torch.telemetry.events import provenance
from repro_torch.telemetry.metrics import run_end_payload
from repro_torch.telemetry.profile import trace_capture
from repro_torch.telemetry.trace import CompileTimer, stage
from repro_torch.tree import tree_leaves

Params = Any

@dataclass(frozen=True)
class FLConfig:
    """The reference's `FLConfig`: same fields, same defaults."""
    dataset: str = "mnist"
    n_clients: int = 50          # N
    m: int = 5                   # M: clients selected per round
    rounds: int = 50             # T: communication budget
    selector: str = "greedyfed"
    selector_kwargs: dict = field(default_factory=dict)
    client: ClientConfig = ClientConfig()
    # round-execution engine: "loop" | "batched" | "scan"
    engine: str = "loop"
    # heterogeneity knobs (paper Section IV)
    dirichlet_alpha: float = 1e-4
    straggler_frac: float = 0.0  # x
    privacy_sigma: float = 0.0   # sigma
    noise_level: float = 0.0     # extra uniform [0, noise_level) sigma
    straggler_rev: int = 1       # 1: pre-drawn (T, N) table; 0: lazy draws
    # virtual-clock timing model; when set, E_k is deadline-derived
    schedule: Optional[ScheduleConfig] = None
    # GTG-Shapley
    shapley_eps: float = 1e-4
    shapley_max_iters: Optional[int] = None   # default 50*M
    shapley_impl: str = "streaming"   # "streaming" | "batched" | "serial"
    sv_chunk: int = 0            # models per SV step (0 auto, < 0 all)
    sv_averaging: str = "mean"   # "mean" | "exponential"
    sv_alpha: float = 0.5
    upload_codec: str = "identity"
    # fault injection (a FaultSpec) and the in-round quarantine screen
    faults: Optional[FaultSpec] = None
    quarantine: bool = False
    quarantine_z: float = 8.0
    # bookkeeping
    eval_every: int = 5
    seed: int = 0
    n_train: int = 6000
    n_val: int = 500
    n_test: int = 1000
    clients_shards: int = 1


class FLResult(NamedTuple):
    config: FLConfig
    test_acc: list            # [(round, acc)]
    val_loss: list            # [(round, loss)]
    final_acc: float
    sv_final: np.ndarray      # (N,)
    selection_counts: np.ndarray
    selections: list          # [np.ndarray (M,)] per round
    shapley_evals: int        # total utility evaluations spent
    wall_time_s: float
    params: Params
    upload_bytes: int = 0     # total client->PS traffic over the run
    download_bytes: int = 0   # total PS->client traffic (model broadcasts)
    sim_time_s: float = 0.0   # virtual-clock seconds (0 without schedule)
    dispatches: int = 0       # the reference's host-level call count
    # one-off seconds: the kernels' nvcc build when this run triggered it
    # (loop, batched), the graph capture (scan, warm-up included)
    compile_time_s: float = 0.0
    execute_time_s: float = 0.0
    quarantined_total: int = 0
    # the port's own: per-round wall seconds and the GTG-Shapley part of
    # each, both measured after a device synchronise (the scan: its
    # replays' device time over the rounds, and no Shapley part)
    round_time_s: tuple = ()
    shapley_time_s: tuple = ()
    # the scan's: host seconds making and staging the draws, and the kernel
    # launches recorded in its captured graphs ({"round": {...}, "eval":
    # {...}}, each replayed once a replay; None when nothing was captured)
    stage_time_s: float = 0.0
    graph_launches: Optional[dict] = None


def _not_in_slice(what: str, slice_: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet: it comes with {slice_} of the PyTorch "
        "port (see ROADMAP.md)")


def check_config(cfg: FLConfig) -> None:
    """Reject what this slice of the port does not run yet."""
    if cfg.engine not in ("loop", "batched", "scan"):
        raise ValueError(f"unknown engine {cfg.engine!r}; "
                         "options: 'loop', 'batched', 'scan'")
    if cfg.shapley_impl not in SHAPLEY_IMPLS:
        raise ValueError(f"unknown shapley_impl {cfg.shapley_impl!r}; "
                         f"options: {SHAPLEY_IMPLS}")
    if cfg.engine == "scan" and cfg.shapley_impl == "serial":
        raise _not_in_slice("shapley_impl='serial' under engine='scan'",
                            "a later scan slice")
    if cfg.faults is not None:
        if getattr(cfg.faults, "_fields", None) != FaultSpec._fields:
            raise ValueError(f"faults must be a FaultSpec, got "
                             f"{type(cfg.faults).__name__}")
        cfg.faults.validate()
    if cfg.clients_shards > 1:
        raise _not_in_slice("clients_shards > 1", "the client-sharding slice")


class RunSetup(NamedTuple):
    """Everything `run_federated` derives from an FLConfig before round 0."""
    data: SynthDataset
    model: ClassifierModel
    rng: np.random.Generator
    draws: RunDraws
    fractions: np.ndarray
    xs: torch.Tensor          # (N, cap, ...) padded client data
    ys: torch.Tensor          # (N, cap) int64
    n_valid: torch.Tensor     # (N,) int64
    n_k_all: torch.Tensor     # (N,) float32
    straggler_ids: set
    sigma_k_all: np.ndarray
    params: Params
    sel_spec: SelectorSpec
    sel_state: DeviceSelectorState
    x_val: torch.Tensor
    y_val: torch.Tensor
    x_test: torch.Tensor
    y_test: torch.Tensor
    model_bytes: int
    clock: Any                # engine.schedule.ClientClock | None
    epochs_table: Any = None  # (T, N) pre-drawn straggler budgets
    fault_table: Any = None   # (T, N) int32 pre-drawn fault codes


def setup_run(cfg: FLConfig, data: Optional[SynthDataset] = None,
              model: Optional[ClassifierModel] = None, *,
              device=None, draws: Optional[RunDraws] = None) -> RunSetup:
    """Partition data, assign heterogeneity, init model/selector state.

    The numpy rng is consumed in the reference's order; the initial model
    comes from `draws.init_params`, which consumes no numpy draw.
    """
    check_config(cfg)
    device = resolve_device(device)
    rng = np.random.default_rng(cfg.seed)
    if draws is None:
        draws = TorchDraws(cfg.seed, device)

    if data is None:
        data = make_dataset(cfg.dataset, n_train=cfg.n_train, n_val=cfg.n_val,
                            n_test=cfg.n_test, seed=cfg.seed)
    if model is None:
        model = make_classifier(cfg.dataset)

    # ---- partition data across clients (Dirichlet x power-law) ----------
    fractions = power_law_fractions(cfg.n_clients, rng)
    parts = dirichlet_partition(data.y_train, cfg.n_clients,
                                cfg.dirichlet_alpha, rng, fractions)
    cap, n = client_cap(parts), len(parts)
    xs = torch.as_tensor(padded_x_block(data.x_train, parts, cap, 0, n),
                         device=device)
    ys = torch.as_tensor(padded_y_block(data.y_train, parts, cap, 0, n),
                         dtype=torch.int64, device=device)
    n_valid_np = valid_counts(parts, 0, n)
    n_valid = torch.as_tensor(n_valid_np, dtype=torch.int64, device=device)

    # ---- heterogeneity assignments --------------------------------------
    n_stragglers = int(round(cfg.straggler_frac * cfg.n_clients))
    straggler_ids = set(rng.choice(cfg.n_clients, n_stragglers,
                                   replace=False).tolist())
    noise_perm = rng.permutation(cfg.n_clients)  # sigma_k = rank * sigma / N
    sigma_k_all = np.zeros(cfg.n_clients, np.float32)
    for rank, k in enumerate(noise_perm):
        sigma_k_all[k] = rank * cfg.privacy_sigma / cfg.n_clients

    # ---- model / selector setup ------------------------------------------
    params = draws.init_params(model)
    sel_kwargs = dict(cfg.selector_kwargs)
    if cfg.selector in ("greedyfed", "greedyfed_dropout"):
        sel_kwargs.setdefault("averaging", cfg.sv_averaging)
        sel_kwargs.setdefault("alpha", cfg.sv_alpha)
    sel_spec = make_selector_spec(cfg.selector, cfg.n_clients, cfg.m,
                                  **sel_kwargs)
    sel_state = init_device_state(sel_spec, cfg.seed, device)
    model_bytes = sum(int(x.numel()) * x.element_size()
                      for x in tree_leaves(params))

    # ---- virtual clock (draws after all earlier consumers of rng) -------
    clock = None
    if cfg.schedule is not None:
        clock = make_client_clock(cfg.schedule, cfg.n_clients, model_bytes,
                                  rng, n_k=n_valid_np[:cfg.n_clients])
    epochs_table = None
    if cfg.straggler_rev >= 1 and clock is None and straggler_ids:
        epochs_table = straggler_epochs_table(
            rng, cfg.rounds, cfg.n_clients, straggler_ids, cfg.client.epochs)
    if cfg.noise_level > 0:
        extra = rng.uniform(0.0, cfg.noise_level, cfg.n_clients)
        sigma_k_all = np.sqrt(sigma_k_all.astype(np.float64) ** 2
                              + extra ** 2).astype(np.float32)
    # ---- faults: the (T, N) code table, after every other draw of rng,
    # and only when faults are on, so fault-free runs keep their stream
    fault_table = None
    if cfg.faults is not None:
        fault_table = draw_fault_table(cfg.faults, cfg.rounds,
                                       cfg.n_clients, rng)

    def dev(a, dtype=None):
        return torch.as_tensor(a, dtype=dtype, device=device)

    return RunSetup(
        data=data, model=model, rng=rng, draws=draws, fractions=fractions,
        xs=xs, ys=ys, n_valid=n_valid, n_k_all=n_valid.to(torch.float32),
        straggler_ids=straggler_ids, sigma_k_all=sigma_k_all, params=params,
        sel_spec=sel_spec, sel_state=sel_state,
        x_val=dev(data.x_val), y_val=dev(data.y_val, torch.int64),
        x_test=dev(data.x_test), y_test=dev(data.y_test, torch.int64),
        model_bytes=model_bytes, clock=clock, epochs_table=epochs_table,
        fault_table=fault_table,
    )


def round_epochs(cfg: FLConfig, s: RunSetup, sel: np.ndarray,
                 t: int = 0) -> np.ndarray:
    """(M,) int32 local-epoch budget E_k for the selected cohort at round t:
    deadline-derived under a schedule, else a gather from the pre-drawn
    straggler table, else (straggler_rev=0) drawn per selected straggler."""
    e = cfg.client.epochs
    if s.clock is not None:
        return deadline_epochs(s.clock, cfg.schedule, sel, e)
    if s.epochs_table is not None:
        return s.epochs_table[t][np.asarray(sel)].astype(np.int32)
    out = np.full(len(sel), e, np.int32)
    for i, k_id in enumerate(sel):
        if int(k_id) in s.straggler_ids:
            out[i] = int(s.rng.integers(1, e + 1))
    return out


def _round_spec(cfg: FLConfig, needs_sv: bool, max_iters: int):
    from repro_torch.engine.round_engine import RoundSpec
    return RoundSpec(needs_sv=needs_sv, shapley_impl=cfg.shapley_impl,
                     shapley_eps=cfg.shapley_eps, shapley_max_iters=max_iters,
                     sv_chunk=cfg.sv_chunk, upload_codec=cfg.upload_codec,
                     faults=cfg.faults, quarantine=cfg.quarantine,
                     quarantine_z=cfg.quarantine_z)


def _make_round_engine(cfg: FLConfig, s: RunSetup, needs_sv: bool,
                       max_iters: int):
    from repro_torch.engine.round_engine import RoundEngine
    return RoundEngine(s.model, cfg.client, _round_spec(cfg, needs_sv,
                                                        max_iters),
                       s.xs, s.ys, s.n_valid, s.sigma_k_all, s.x_val,
                       s.y_val, s.draws)


def run_federated(cfg: FLConfig, data: Optional[SynthDataset] = None,
                  model: Optional[ClassifierModel] = None, *,
                  device=None, draws: Optional[RunDraws] = None,
                  telemetry=None, rounds_per_segment: int = 0) -> FLResult:
    """Drive one federated run on `device` (default: the CUDA card).

    `draws` replaces the run's default torch-generator draws (a test hands
    the reference's draws in through it).  Under engine="scan",
    `rounds_per_segment` K > 0 reads the run back every K rounds (the
    segmented run equals the whole run bit for bit); other engines ignore
    it.  `telemetry` (a `repro_torch.telemetry.Telemetry`, default None)
    streams the run; it changes no output and no dispatch count.
    """
    t_start = time.perf_counter()
    ctimer = CompileTimer()
    with ctimer:
        s = setup_run(cfg, data, model, device=device, draws=draws)
    if telemetry is not None:
        telemetry.emit("run_start", run_id=telemetry.run_id, kind="solo",
                       engine=cfg.engine, selector=cfg.selector,
                       n_clients=cfg.n_clients, m=cfg.m, rounds=cfg.rounds,
                       seed=cfg.seed, eval_every=cfg.eval_every,
                       provenance=provenance())
    if cfg.engine == "scan":
        from repro_torch.engine.scan_engine import run_federated_scan
        return run_federated_scan(cfg, s, t_start,
                                  rounds_per_segment=rounds_per_segment,
                                  telemetry=telemetry, ctimer=ctimer)
    device = s.n_valid.device
    model, params, draws = s.model, s.params, s.draws
    spec, sstate = s.sel_spec, s.sel_state

    def utility_fn(p):  # U(w) = -L(w; D_val)
        with torch.no_grad():
            return -model.loss(p, s.x_val, s.y_val)

    batched_utility_fn = make_batched_mlp_utility(model, s.x_val, s.y_val)
    needs_sv = spec.uses_shapley
    max_iters = cfg.shapley_max_iters or 50 * cfg.m

    fractions = torch.as_tensor(s.fractions, dtype=torch.float32,
                                device=device)
    zero_losses = torch.zeros((cfg.n_clients,), device=device)
    d_sched = poc_d_schedule(spec, cfg.rounds)
    emask = eval_mask(cfg.rounds, cfg.eval_every)

    # hardening: the loop engine calls the batched round's own
    # `harden_cohort`, so all engines quarantine the same clients
    hardened = cfg.faults is not None or cfg.quarantine

    def round_codes(sel, t):
        if s.fault_table is not None:
            return s.fault_table[t][np.asarray(sel)]
        return np.zeros(len(sel), np.int32)

    engine = None
    codec_bytes = s.model_bytes
    if cfg.engine == "batched":
        engine = _make_round_engine(cfg, s, needs_sv, max_iters)
        codec_bytes = engine.upload_nbytes_per_client(params)
    from repro_torch.engine.round_engine import round_plan
    plan = round_plan(engine.spec if engine is not None else
                      _round_spec(cfg, needs_sv, max_iters), cfg.client,
                      (spec,), cfg.n_clients, cfg.m, params,
                      s.n_valid.cpu().numpy())

    test_acc, val_loss_hist, selections = [], [], []
    round_times, shapley_times = [], []
    total_evals = upload_bytes = download_bytes = dispatches = 0
    quarantined_total = 0
    sv_rounds = trunc_rounds = 0   # telemetry-only truncation counters
    vclock = VirtualClock() if s.clock is not None else None

    # the kernels' build, if this run is the first to launch one, is
    # charged to compile_time_s by the active timer
    with ctimer, trace_capture(telemetry, label=f"{cfg.engine}_rounds"):
        for t in range(cfg.rounds):
            synchronize(device)
            t_round = time.perf_counter()
            with stage("select"):
                losses = zero_losses
                if spec.uses_local_losses:
                    losses = local_loss(model, params, s.xs, s.ys, s.n_valid)
                    dispatches += 1

                ctx = DeviceSelectionContext(data_fractions=fractions,
                                             local_losses=losses,
                                             poc_d=int(d_sched[t]))
                rd = draws.round(t, plan).to(device)
                sel_dev, sstate = device_select(spec, sstate, ctx,
                                                rd.selection)
                sel = sel_dev.cpu().numpy().astype(np.int64)
            selections.append(sel)
            epochs_k = round_epochs(cfg, s, sel, t)

            sel_t = torch.as_tensor(sel, device=device)
            sv_round = None
            evals_round, trunc_round, q_round = 0, False, 0
            if engine is not None:
                # ---- fused round: ONE call for train+codec+SV+average -----
                out = engine.step(params, sel, epochs_k, t, rd,
                                  fault_codes=(round_codes(sel, t)
                                               if hardened else None))
                params = out.params
                if needs_sv:
                    sv_round = out.sv
                    evals_round = out.utility_evals
                    trunc_round = out.sv_truncated
                    total_evals += evals_round
                shapley_times.append(out.shapley_time_s)
                if hardened:
                    # only survivors are charged: a quarantined upload
                    # never reaches the server (crash) or is dropped
                    q_round = int(out.quarantined)
                    quarantined_total += q_round
                    round_upload = codec_bytes * int(out.ok.sum())
                else:
                    round_upload = codec_bytes * len(sel)
                upload_bytes += round_upload
                dispatches += 1
            else:
                # ---- ClientUpdate at each selected client -----------------
                updates, nbytes_list = [], []
                with stage("train"):
                    idx = minibatch_rows(rd.rows, sel_t, s.n_valid)
                    for i, k_id in enumerate(sel):
                        upd = client_update(
                            model, cfg.client, params, s.xs[k_id],
                            s.ys[k_id], int(epochs_k[i]),
                            float(s.sigma_k_all[k_id]), idx[i],
                            [n[i] for n in rd.noise])
                        if cfg.upload_codec != "identity":
                            with stage("codec"):
                                upd, nbytes = compress_update(
                                    cfg.upload_codec, upd, params)
                        else:
                            nbytes = s.model_bytes
                        nbytes_list.append(nbytes)
                        updates.append(upd)
                dispatches += len(sel)

                stacked = tree_stack(updates)
                n_k_sel = s.n_k_all[sel_t]

                # ---- hardening: inject, screen, mask ----------------------
                h = None
                n_k_sv = n_k_sel
                round_upload = int(sum(nbytes_list))
                if hardened:
                    with stage("quarantine"):
                        codes = torch.as_tensor(round_codes(sel, t),
                                                device=device)
                        h = harden_cohort(stacked, params, n_k_sel, codes,
                                          faults=cfg.faults,
                                          quarantine=cfg.quarantine,
                                          z=cfg.quarantine_z)
                        stacked, n_k_sv = h.stacked, h.n_k_sv
                        ok = h.ok.cpu().numpy()
                    q_round = int(h.quarantined)
                    quarantined_total += q_round
                    round_upload = int(sum(nb for nb, good
                                           in zip(nbytes_list, ok) if good))
                    dispatches += 1

                # ---- GTG-Shapley at the PS --------------------------------
                # the walks are drawn before the stage's timer, as the
                # batched engine draws them before its round step
                if needs_sv:
                    walks = (draws.perm_batches(t, cfg.m)
                             if cfg.shapley_impl == "serial" else rd.walks)
                    with stage("shapley"):
                        sv_round, stats, sv_s = shapley_stage(
                            cfg.shapley_impl, stacked, n_k_sv, params,
                            utility_fn, batched_utility_fn, walks,
                            eps=cfg.shapley_eps, max_iters=max_iters,
                            sv_chunk=cfg.sv_chunk)
                    shapley_times.append(sv_s)
                    evals_round = stats.utility_evals
                    trunc_round = stats.truncated_round
                    total_evals += evals_round
                    dispatches += 1
                    if h is not None:
                        # quarantined rows walked as w_prev at 2^-100: no
                        # credit
                        sv_round = torch.where(h.ok, sv_round, 0.0)
                else:
                    shapley_times.append(0.0)

                # ---- ModelAverage (Alg. 1 line 9) -------------------------
                with stage("aggregate"):
                    if h is not None:
                        params = masked_average(stacked, h.n_k_agg, h.ok,
                                                params)
                    else:
                        with torch.no_grad():
                            params = weighted_average(
                                stacked, normalized_weights(n_k_sel))
                dispatches += 1
                upload_bytes += round_upload
            download_bytes += s.model_bytes * len(sel)  # w^t broadcast
            if vclock is not None:
                vclock.advance(round_duration_s(s.clock, cfg.schedule, sel,
                                                epochs_k))

            sstate = device_update(spec, sstate, sel_t, sv_round)

            if emask[t]:
                with stage("eval"), torch.no_grad():
                    acc = float(model.accuracy(params, s.x_test, s.y_test))
                    vl = float(-utility_fn(params))
                test_acc.append((t + 1, acc))
                val_loss_hist.append((t + 1, vl))
                dispatches += 2
            synchronize(device)
            round_times.append(time.perf_counter() - t_round)

            if telemetry is not None:
                if needs_sv:
                    sv_rounds += 1
                    trunc_rounds += bool(trunc_round)
                fields = dict(round=t, selections=sel, epochs=epochs_k,
                              utility_evals=int(evals_round),
                              sv_truncated=bool(trunc_round),
                              upload_bytes=round_upload,
                              download_bytes=s.model_bytes * len(sel))
                if hardened:
                    fields["quarantined"] = q_round
                if sv_round is not None:
                    fields["sv"] = sv_round.cpu().numpy()
                telemetry.emit("round_metrics", **fields)
                if emask[t]:
                    telemetry.emit("eval", round=t, test_acc=acc, val_loss=vl)

    wall = time.perf_counter() - t_start
    compile_s = ctimer.seconds
    final_acc = test_acc[-1][1] if test_acc else float("nan")
    if telemetry is not None:
        telemetry.emit("compile", seconds=compile_s,
                       program=f"{cfg.engine}_round_programs")
        telemetry.emit("run_end", **run_end_payload(
            rounds=cfg.rounds, wall_time_s=wall, compile_time_s=compile_s,
            final_acc=final_acc, utility_evals=total_evals,
            upload_bytes=upload_bytes, download_bytes=download_bytes,
            sv_rounds=sv_rounds, truncated_rounds=trunc_rounds,
            dispatches=dispatches))
    return FLResult(
        config=cfg,
        test_acc=test_acc,
        val_loss=val_loss_hist,
        final_acc=final_acc,
        sv_final=sstate.valuation.sv.cpu().numpy(),
        selection_counts=sstate.valuation.counts.cpu().numpy(),
        selections=selections,
        shapley_evals=total_evals,
        wall_time_s=wall,
        params=params,
        upload_bytes=upload_bytes,
        download_bytes=download_bytes,
        sim_time_s=vclock.now_s if vclock is not None else 0.0,
        dispatches=dispatches,
        compile_time_s=compile_s,
        execute_time_s=max(wall - compile_s, 0.0),
        quarantined_total=quarantined_total,
        round_time_s=tuple(round_times),
        shapley_time_s=tuple(shapley_times),
    )


def run_federated_replicated(cfg: FLConfig, seeds,
                             data: Optional[SynthDataset] = None,
                             model: Optional[ClassifierModel] = None,
                             selectors=None, *, device=None, draws=None,
                             telemetry=None, **grid_kwargs) -> list[FLResult]:
    """Run a replica batch on `device` (default: the CUDA card).

    With ``cfg.engine != "scan"`` and no `selectors`, each seed is a solo
    run on the batched engine (`engine/replicated.py::run_replicated`).  With ``cfg.engine ==
    "scan"`` (or a `selectors` list of registry names) the whole
    strategies x seeds table runs through `repro_torch.grid.run_grid`: one
    captured round graph per capability partition, optionally segmented
    and checkpointed through the keywords; results come back
    selector-major, seed-minor.  `draws` gives one `RunDraws` source per
    replica (a test hook, as `run_federated`'s); `telemetry` streams the
    grid, or each seed's batched run."""
    from repro_torch.engine.replicated import (
        run_replicated, run_replicated_scan,
    )
    if cfg.engine == "scan" or selectors is not None:
        return run_replicated_scan(cfg, seeds, selectors=selectors,
                                   data=data, model=model, device=device,
                                   draws=draws, telemetry=telemetry,
                                   **grid_kwargs)
    if grid_kwargs:
        raise ValueError("grid options (rounds_per_segment, "
                         "checkpoint_dir, ...) require engine='scan'")
    return run_replicated(cfg, seeds, data=data, model=model, device=device,
                          draws=draws, telemetry=telemetry)


def run_centralized(cfg: FLConfig, data: Optional[SynthDataset] = None,
                    model: Optional[ClassifierModel] = None, *,
                    device=None, draws: Optional[RunDraws] = None
                    ) -> FLResult:
    """Upper bound: the server trains on the pooled data, same step budget.
    Round t's minibatch table and noise are those of slot 0 of a one-slot
    round over the pooled data (`draws.round(t, ...)`).
    """
    device = resolve_device(device)
    if data is None:
        data = make_dataset(cfg.dataset, n_train=cfg.n_train, n_val=cfg.n_val,
                            n_test=cfg.n_test, seed=cfg.seed)
    if model is None:
        model = make_classifier(cfg.dataset)
    if draws is None:
        draws = TorchDraws(cfg.seed, device)
    params = draws.init_params(model)
    shapes = [tuple(x.shape) for x in tree_leaves(params)]

    x = torch.as_tensor(data.x_train, device=device)
    y = torch.as_tensor(data.y_train, dtype=torch.int64, device=device)
    x_test = torch.as_tensor(data.x_test, device=device)
    y_test = torch.as_tensor(data.y_test, dtype=torch.int64, device=device)
    n_rows = torch.tensor([x.shape[0]])
    plan = DrawPlan(selection=(), n_clients=1, m=1,
                    n_steps=cfg.client.epochs * cfg.client.batches_per_epoch,
                    batch_size=cfg.client.batch_size, shapes=tuple(shapes),
                    n_perms=0, n_valid=(x.shape[0],))
    t_start = time.perf_counter()
    test_acc = []
    emask = eval_mask(cfg.rounds, cfg.eval_every)
    for t in range(cfg.rounds):
        rd = draws.round(t, plan)
        idx = minibatch_rows(rd.rows, torch.zeros((1,), dtype=torch.int64),
                             n_rows)[0]
        params = client_update(model, cfg.client, params, x, y,
                               cfg.client.epochs, 0.0, idx.to(device),
                               [n[0].to(device) for n in rd.noise])
        if emask[t]:
            with torch.no_grad():
                test_acc.append((t + 1, float(model.accuracy(params, x_test,
                                                             y_test))))
    return FLResult(cfg, test_acc, [], test_acc[-1][1],
                    np.zeros(cfg.n_clients),
                    np.zeros(cfg.n_clients, np.int32), [], 0,
                    time.perf_counter() - t_start, params)
