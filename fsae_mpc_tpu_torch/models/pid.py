"""PID actuator loop as a pure function with an explicit state (port of
``fsae_mpc_tpu.models.pid``), elementwise over a batch: the state
``(integral_error, prev_error)`` holds one entry per instance.
"""

from __future__ import annotations

import torch

from ..config import PidParams


def pid_init(like):
    """A zero state shaped and placed like the tensor ``like``."""
    return (torch.zeros_like(like), torch.zeros_like(like))


def pid_step(target, current, params: PidParams, state):
    integral, prev_error = state
    error = target - current
    integral = integral + error
    derivative = error - prev_error
    out = params.kp * error + params.ki * integral + params.kd * derivative
    out = torch.clamp(out, -params.max_output, params.max_output)
    return out, (integral, error)
