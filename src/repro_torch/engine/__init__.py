"""repro_torch.engine — host-side scheduling (the fused round and whole-run
engines of `repro.engine` are later slices of the port)."""
from repro_torch.engine.schedule import (
    ClientClock, ScheduleConfig, VirtualClock, deadline_epochs,
    deadline_epochs_table, eval_mask, make_client_clock, round_duration_s,
    straggler_epochs_table,
)

__all__ = [
    "ClientClock", "ScheduleConfig", "VirtualClock", "deadline_epochs",
    "deadline_epochs_table", "eval_mask", "make_client_clock",
    "round_duration_s", "straggler_epochs_table",
]
