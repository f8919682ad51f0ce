"""Pre-drawn (T, N) fault-code tables on the run's numpy rng (counterpart
of `repro/faults/table.py`, the same draws bit for bit).

`setup_run` draws the table once, after every other draw of its rng and
only when `cfg.faults` is set, so fault-free runs keep their stream.  The
three engines read the same table: the loop and batched engines gather
the cohort's codes on the host, the scan gathers them on the card from a
device copy by the round counter.
"""
from __future__ import annotations

import numpy as np

from repro_torch.faults.spec import FAULT_CODES, FaultSpec


def draw_fault_table(spec: FaultSpec, rounds: int, n_clients: int,
                     rng: np.random.Generator) -> np.ndarray:
    """(rounds, n_clients) int32 fault codes; 0 = honest.

    Two rng draws per table (fire mask, kind choice) whatever fires, so
    the stream position depends only on the table's shape.
    """
    spec.validate()
    codes = np.asarray([FAULT_CODES[k] for k in spec.kinds], np.int32)
    fire = rng.random((rounds, n_clients)) < spec.rate
    idx = rng.integers(0, len(codes), size=(rounds, n_clients))
    table = np.where(fire, codes[idx], 0).astype(np.int32)
    if spec.start_round > 0:
        table[: spec.start_round] = 0
    return table
