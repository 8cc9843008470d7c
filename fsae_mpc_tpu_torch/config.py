"""Central configuration dataclasses (PyTorch port of ``fsae_mpc_tpu.config``).

Plain frozen dataclasses of Python floats: the vehicle and MPC constants
enter the models as scalars, so no tensor state lives here.  Field names,
defaults and the ``MPC_F32`` profile are the JAX package's.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class VehicleParams:
    """Vehicle + tyre constants (``fsae_mpc_tpu.config.VehicleParams``)."""

    m: float = 280.0        # mass [kg]
    Iz: float = 200.0       # yaw inertia [kg m^2]
    lr: float = 0.6183      # CoG -> rear axle [m]
    lf: float = 0.8672      # CoG -> front axle [m]
    g: float = 9.81
    # Pacejka magic-formula coefficients
    pB: float = 12.56
    pC: float = 1.38
    pD: float = 1.60
    pE: float = -0.58
    # friction-ellipse semi-axes (lateral accel, longitudinal accel)
    ac_max: float = 9.163
    al_max: float = 10.0
    # low-speed softening scale: x_d_hat = x_d + v_soft * exp(-x_d / v_soft)
    v_soft: float = 5.0
    # cartesian-plant slip-angle regulariser
    v_eps: float = 0.01

    @property
    def wheelbase(self):
        return self.lr + self.lf

    @property
    def lr_ratio(self):
        return self.lr / (self.lr + self.lf)


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
