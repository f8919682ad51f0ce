"""repro_torch.grid — the segmented, resumable experiment-grid runner
(counterpart of `repro.grid`).

The paper's results are grids: every table sweeps strategies x seeds x a
knob under a fixed round budget.

  * `spec`      — GridSpec/GridCell/GridResult: the declarative grid API;
  * `partition` — cells grouped by capability (needs_sv / local losses)
                  and codec, so FedAvg-family cells skip GTG-Shapley;
  * `segments`  — a partition's replicas in one captured round graph,
                  chained over T/K segments, checkpointed at every
                  boundary for a bit-identical resume;
  * `shard`     — replicas and clients over the ranks of a
                  `torch.distributed` world (`launch/mesh.py`'s run
                  meshes): whole replicas a replica row, one client block
                  a rank of a row;
  * `runner`    — `run_grid`, the single entry point.
"""
from repro_torch.grid.runner import run_grid
from repro_torch.grid.spec import CellFailure, GridCell, GridResult, GridSpec

__all__ = ["CellFailure", "GridCell", "GridResult", "GridSpec", "run_grid"]
