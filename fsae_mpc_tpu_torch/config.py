"""Central configuration dataclasses (PyTorch port of ``fsae_mpc_tpu.config``).

Frozen dataclasses.  The MPC and PID constants are Python numbers.  A
vehicle's constants are Python floats, shared by every instance of a
batch, or (B,) tensors, one value per instance (a scenario sweep of
perturbed vehicles, ``sim.batch.perturbed_params``), field by field, as
the JAX package's pytree dataclass holds them.  Field names, defaults and
the ``MPC_F32`` profile are the JAX package's.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class VehicleParams:
    """Vehicle + tyre constants (``fsae_mpc_tpu.config.VehicleParams``).

    Each field is a float, shared by a batch, or a (B,) tensor on the
    batch's device, one value per instance.  The per-instance models read
    them inside ``torch.func.vmap`` (``models.instances``); code over a
    batch broadcasts a (B,) field against its (B, ...) tensors."""

    m: Any = 280.0        # mass [kg]
    Iz: Any = 200.0       # yaw inertia [kg m^2]
    lr: Any = 0.6183      # CoG -> rear axle [m]
    lf: Any = 0.8672      # CoG -> front axle [m]
    g: Any = 9.81
    # Pacejka magic-formula coefficients
    pB: Any = 12.56
    pC: Any = 1.38
    pD: Any = 1.60
    pE: Any = -0.58
    # friction-ellipse semi-axes (lateral accel, longitudinal accel)
    ac_max: Any = 9.163
    al_max: Any = 10.0
    # low-speed softening scale: x_d_hat = x_d + v_soft * exp(-x_d / v_soft)
    v_soft: Any = 5.0
    # cartesian-plant slip-angle regulariser
    v_eps: Any = 0.01

    @property
    def wheelbase(self):
        return self.lr + self.lf

    @property
    def lr_ratio(self):
        return self.lr / (self.lr + self.lf)

    def instance_dims(self) -> tuple:
        """Per field, in field order: 0 where it holds one value per
        instance (a (B,) tensor), None where the batch shares it."""
        return tuple(0 if torch.is_tensor(v) and v.ndim else None
                     for v in (getattr(self, f.name)
                               for f in dataclasses.fields(self)))


@dataclasses.dataclass(frozen=True)
class PidParams:
    """Gains + output clamp of one PID loop."""

    kp: float = 0.0
    ki: float = 0.0
    kd: float = 0.0
    max_output: float = 0.0


VEL_PID = PidParams(kp=16000.0, ki=0.0, kd=0.0, max_output=2800.0)
STEER_PID = PidParams(kp=80.0, ki=0.0, kd=0.0, max_output=0.8)


@dataclasses.dataclass(frozen=True)
class MPCParams:
    """Static MPC shape/weight configuration."""

    n_steps: int = 40
    dt: float = 0.05
    target_vel: float = 20.0

    # cost weights
    q_s: float = 5.0
    q_n: float = 250.0
    q_mu: float = 2000.0
    r_a: float = 10.0
    r_delta_d: float = 10.0
    q_terminal_scale: float = 10.0

    # bounds
    n_max: float = 0.75       # track half-width (soft)
    delta_max: float = 0.4    # steering angle bound
    a_max: float = 10.0       # accel input bound
    delta_d_max: float = 0.4  # steering-rate bound
    ay_max: float = 5.0       # kinematic lateral-accel proxy bound
    slip_max: float = 0.1     # dynamic slip-angle bound

    # soft-constraint weights
    w_track: float = 1e8
    w_slip: float = 1e6
    w_tyre: float = 1e4

    n_tyre_polygon: int = 12  # friction-ellipse polygon sides (LTV dynamic)


DEFAULT_MPC = MPCParams()

# float32 soft-constraint profile: the reference's 1e8/1e6/1e4 weights
# exceed the exact-penalty threshold by ~4 orders of magnitude, which in
# float32 wrecks the IPM's KKT conditioning; these compressed weights stay
# above every observed constraint dual, so the minimiser is unchanged.
MPC_F32 = MPCParams(w_track=1e5, w_slip=1e4, w_tyre=1e3)
