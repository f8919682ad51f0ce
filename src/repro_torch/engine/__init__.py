"""repro_torch.engine — round execution engines (counterpart of
`repro.engine`).

    batch_client  the cohort's ClientUpdate as one batch of M models
    round_engine  the fused round: one call per round (engine="batched"),
                  and the scan body and its captured segments
    scan_engine   the whole run with no host sync between rounds
                  (engine="scan")
    replicated    seeds of one config on the batched engine, and the
                  seeds x strategies grid (`repro_torch.grid`)
    schedule      virtual clock: latencies, deadlines, time-derived E_k
"""
from repro_torch.engine.batch_client import (
    batched_client_update, cohort_update,
)
from repro_torch.engine.round_engine import (
    RoundEngine, RoundOutput, RoundSpec, ScanOperands, ScanRunOutput,
    ScanSpec, SegmentCarry, SegmentOutput, SegmentStep, make_round_step,
    make_run_scan, make_segment_step,
)
from repro_torch.engine.scan_engine import (
    build_epochs_table, build_fault_table, make_scan_spec,
    results_from_scan, run_federated_scan, scan_operands,
)
from repro_torch.engine.schedule import (
    ClientClock, ScheduleConfig, VirtualClock, deadline_epochs,
    deadline_epochs_table, eval_mask, make_client_clock, round_duration_s,
    straggler_epochs_table,
)

__all__ = [
    "batched_client_update", "cohort_update",
    "RoundEngine", "RoundOutput", "RoundSpec", "make_round_step",
    "ScanOperands", "ScanRunOutput", "ScanSpec", "SegmentCarry",
    "SegmentOutput", "SegmentStep", "make_run_scan", "make_segment_step",
    "build_epochs_table", "build_fault_table", "make_scan_spec",
    "results_from_scan", "run_federated_scan", "scan_operands",
    "ClientClock", "ScheduleConfig", "VirtualClock", "deadline_epochs",
    "deadline_epochs_table", "eval_mask", "make_client_clock",
    "round_duration_s", "straggler_epochs_table",
]
