"""repro_torch.engine — round execution engines (counterpart of
`repro.engine`).

    batch_client  the cohort's ClientUpdate as one batch of M models
    round_engine  the fused round: one call per round (engine="batched")
    schedule      virtual clock: latencies, deadlines, time-derived E_k

The whole-run scan engine and the replica engines are later slices of the
port.
"""
from repro_torch.engine.batch_client import (
    batched_client_update, cohort_update,
)
from repro_torch.engine.round_engine import (
    RoundEngine, RoundOutput, RoundSpec, make_round_step,
)
from repro_torch.engine.schedule import (
    ClientClock, ScheduleConfig, VirtualClock, deadline_epochs,
    deadline_epochs_table, eval_mask, make_client_clock, round_duration_s,
    straggler_epochs_table,
)

__all__ = [
    "batched_client_update", "cohort_update",
    "RoundEngine", "RoundOutput", "RoundSpec", "make_round_step",
    "ClientClock", "ScheduleConfig", "VirtualClock", "deadline_epochs",
    "deadline_epochs_table", "eval_mask", "make_client_clock",
    "round_duration_s", "straggler_epochs_table",
]
