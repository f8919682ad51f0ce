"""Launchers of the port (counterpart of `repro/launch/`): `train.py`.
The reference's other launch modules are ROADMAP queue 1, item 7c."""
