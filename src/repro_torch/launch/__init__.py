"""Launchers of the port (counterpart of `repro/launch/`): `train.py`, and
for one H100 `roofline.py` (the card's rates, the kernels' cost formulas,
the step roofline), `compat.py` (the counting mode that stands in for
XLA's cost and memory analyses), `shapes.py`, `dryrun.py` and
`hillclimb.py`; and `mesh.py`'s run meshes (replicas and clients over
`torch.distributed`, the two collectives of a client-sharded round).  The
reference's production and debug meshes, `sharding.py` and the
multi-device dry-run (the LMs' tensor parallelism) come with a later slice
(ROADMAP)."""
