"""repro_torch.faults: deterministic fault injection and cohort hardening
(counterpart of `repro.faults`).

A `FaultSpec` declares client-level faults (NaN/Inf updates, sign-flip or
scaled byzantine updates, a mid-round crash that drops the client out)
that `setup_run` pre-draws into a (T, N) int32 code table on the run's
numpy rng, so the loop, batched and scan engines read the same faults.
`harden_cohort` is the shared in-round stage: inject the faults into the
decoded cohort, screen the deltas (finite check and a median/MAD norm
cutoff) and mask quarantined clients out of aggregation, the byte ledger
and the SV walks.  The reference's `jitted_harden` has no counterpart:
the host engines call `harden_cohort` itself.
"""
from repro_torch.faults.spec import (
    CODE_CRASH, CODE_INF, CODE_NAN, CODE_NONE, CODE_SCALE, CODE_SIGN_FLIP,
    FAULT_CODES, FAULT_KINDS, FaultSpec,
)
from repro_torch.faults.table import draw_fault_table
from repro_torch.faults.quarantine import (
    HardenedCohort, TINY_WEIGHT, apply_faults, harden_cohort,
    masked_average, screen_cohort,
)

__all__ = [
    "CODE_CRASH", "CODE_INF", "CODE_NAN", "CODE_NONE", "CODE_SCALE",
    "CODE_SIGN_FLIP", "FAULT_CODES", "FAULT_KINDS", "FaultSpec",
    "HardenedCohort", "TINY_WEIGHT", "apply_faults", "draw_fault_table",
    "harden_cohort", "masked_average", "screen_cohort",
]
