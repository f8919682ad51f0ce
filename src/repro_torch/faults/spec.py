"""Fault model declaration: kinds, codes and the hashable FaultSpec (a
copy of `repro/faults/spec.py`, which the port may not import).

Fault codes are what the rounds read: a (T, N) int32 table where 0 means
"honest" and each nonzero code names one client-level fault for that
(round, client) pair.  The codes are the reference's: never renumber,
only append.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

# code 0 is reserved for "no fault"; the table draw maps kind names to
# these codes.  CRASH is a systems fault (the client never reports back,
# so it drops out: its update is bitwise untouched but masked from
# aggregation and the byte ledger); the rest corrupt the update itself.
CODE_NONE, CODE_NAN, CODE_INF, CODE_SIGN_FLIP, CODE_SCALE, CODE_CRASH = range(6)

FAULT_KINDS: Tuple[str, ...] = ("nan", "inf", "sign_flip", "scale", "crash")
FAULT_CODES = {
    "nan": CODE_NAN,
    "inf": CODE_INF,
    "sign_flip": CODE_SIGN_FLIP,
    "scale": CODE_SCALE,
    "crash": CODE_CRASH,
}


class FaultSpec(NamedTuple):
    """Declarative, seeded client-fault injection.

    rate          per-(round, client) probability that a fault fires
    kinds         which faults to draw from, uniformly, when one fires
    scale         magnitude for "scale" (delta * scale) and "sign_flip"
                  (delta * -scale) byzantine updates
    start_round   faults only fire from this round on
    """

    rate: float = 0.1
    kinds: Tuple[str, ...] = ("nan", "sign_flip", "crash")
    scale: float = 10.0
    start_round: int = 0

    def validate(self) -> "FaultSpec":
        unknown = [k for k in self.kinds if k not in FAULT_CODES]
        if unknown:
            raise ValueError(
                f"unknown fault kinds {unknown}; known: {FAULT_KINDS}")
        if not self.kinds:
            raise ValueError("FaultSpec.kinds must name at least one kind")
        if not 0.0 <= self.rate <= 1.0:
            raise ValueError(f"FaultSpec.rate must be in [0, 1], got {self.rate}")
        if self.start_round < 0:
            raise ValueError(f"FaultSpec.start_round must be >= 0, got "
                             f"{self.start_round}")
        return self
