"""Explicit Runge-Kutta steps + discrete-step linearisation (port of
``fsae_mpc_tpu.models.integrators``).

``linearize_discrete`` differentiates the discrete step with
``torch.func.jacfwd`` and batches it with ``torch.func.vmap`` over every
leading dimension of the trajectory, so a (B, N, nx) batch of horizons is
linearised in one call; per-instance data (vehicle parameters, tracks)
enters as mapped arguments (``models.instances``).
"""

from __future__ import annotations

from torch.func import jacfwd

from ..ops.precision import highest as _highest_precision
from .instances import vmap_instances


def euler_step(f, x, u, dt):
    return x + dt * f(x, u)


def rk2_step(f, x, u, dt):
    """Explicit midpoint (x_{k+1} = x + dt * k2)."""
    k1 = f(x, u)
    k2 = f(x + 0.5 * dt * k1, u)
    return x + dt * k2


def rk4_step(f, x, u, dt):
    k1 = f(x, u)
    k2 = f(x + 0.5 * dt * k1, u)
    k3 = f(x + 0.5 * dt * k2, u)
    k4 = f(x + dt * k3, u)
    return x + dt * (k1 + 2.0 * k2 + 2.0 * k3 + k4) / 6.0


def rk6_step(f, x, u, dt):
    """The six-stage explicit RK step of the simulation plant, with the
    JAX package's tableau verbatim, quirks included: the k5 stage combines
    ``7/27*k2 + 10/27*k2`` (k3 is unused there).  The plant is the closed
    loop's ground truth, so the reference's coefficients beat textbook
    ones."""
    k1 = f(x, u)
    k2 = f(x + k1 * dt / 2.0, u)
    k3 = f(x + k1 * dt / 4.0 + k2 * dt / 8.0, u)
    k4 = f(x - k2 * dt + 2.0 * k3 * dt, u)
    k5 = f(x + (7.0 / 27.0) * k2 * dt + (10.0 / 27.0) * k2 * dt
           + k4 * dt / 27.0, u)
    k6 = f(x + (28.0 / 625.0) * k1 * dt - k2 * dt / 5.0
           + (546.0 / 625.0) * k3 * dt + (54.0 / 625.0) * k4 * dt
           - (378.0 / 625.0) * k5 * dt, u)
    fbar = (k1 / 24.0 + 5.0 / 48.0 * k4 + 27.0 / 56.0 * k5
            + 125.0 / 336.0 * k6)
    return x + dt * fbar


STEPPERS = {"euler": euler_step, "rk2": rk2_step, "rk4": rk4_step,
            "rk6": rk6_step}


def discrete_step(f, stepper: str, dt):
    """The per-instance step ``step(x, u, *data)`` of ``STEPPERS[stepper]``
    on the ODE ``f(x, u, *data)`` (``data``: e.g. the track and the
    vehicle parameters)."""
    rk = STEPPERS[stepper]
    return lambda x, u, *data: rk(lambda xx, uu: f(xx, uu, *data), x, u, dt)


@_highest_precision
def linearize_discrete(step, x_traj, u_traj, data=()):
    """Linearise ``step(x, u, *data) -> x_next`` along a trajectory.

    ``x_traj (..., nx)``, ``u_traj (..., nu)`` with any leading dimensions
    (a batch of horizons is ``(B, N, ...)``); ``data``: the step's
    per-instance data, mapped over the first of them where it holds one
    value per instance.  Returns ``(Ad, Bd, dd)`` with
    ``x_{k+1} ~= Ad x_k + Bd u_k + dd``.
    """
    def one(x, u, *d):
        st = lambda xx, uu: step(xx, uu, *d)
        # torch.func's forward mode promotes a 0-d tensor times a Python
        # float to float64 in the tangents; the Jacobians come back in the
        # trajectory's dtype
        Ad = jacfwd(st, argnums=0)(x, u).to(x.dtype)
        Bd = jacfwd(st, argnums=1)(x, u).to(x.dtype)
        dd = st(x, u).to(x.dtype) - Ad @ x - Bd @ u
        return Ad, Bd, dd

    return vmap_instances(one, (x_traj, u_traj), x_traj.ndim - 1, data)
