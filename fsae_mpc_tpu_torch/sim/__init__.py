"""Closed-loop lap simulation."""

from .closed_loop import SimConfig, SimOutputs, simulate, simulate_timed  # noqa: F401
