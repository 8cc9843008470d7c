"""Closed-loop lap simulation, scenario batching and checkpoints."""

from .batch import perturbed_params, simulate_batch  # noqa: F401
from .closed_loop import (SimConfig, SimOutputs, simulate,  # noqa: F401
                          simulate_chunked, simulate_timed)
