"""Launchers of the port (counterpart of `repro/launch/`): `train.py`, and
for one H100 `roofline.py` (the card's rates, the kernels' cost formulas,
the step roofline), `compat.py` (the counting mode that stands in for
XLA's cost and memory analyses), `shapes.py`, `dryrun.py` and
`hillclimb.py`.  The reference's `mesh.py` and `sharding.py` come with
client sharding (ROADMAP queue 1, item 8)."""
