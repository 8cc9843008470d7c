"""Cartesian-frame vehicle ODEs: the simulation's ground-truth plant (port
of ``fsae_mpc_tpu.models.cartesian``).

Written over the last axis -- ``x`` (..., nx), ``u`` (..., nu) -- so a
batch of plants steps in one call and a single instance is the same code.
"""

from __future__ import annotations

import torch

from ..config import VehicleParams
from .curvilinear import pacejka
from .integrators import rk6_step


def f_cart_kin(x, u, params: VehicleParams = VehicleParams()):
    """Kinematic bicycle.  State ``[x, y, theta, v, delta]``, control
    ``[a, delta_d]``."""
    _, _, theta, v, delta = x.unbind(-1)
    beta = torch.arctan(params.lr_ratio * torch.tan(delta))
    return torch.stack([
        v * torch.cos(theta + beta),
        v * torch.sin(theta + beta),
        v / params.lr * torch.sin(beta),
        u[..., 0],
        u[..., 1],
    ], -1)


def f_cart_dyn(x, u, params: VehicleParams = VehicleParams()):
    """Dynamic Pacejka bicycle -- the closed-loop plant.  State
    ``[x, y, theta, x_d, y_d, theta_d, delta]``, control ``[Fx, delta_d]``
    (a raw force, unlike the curvilinear model's acceleration)."""
    _, _, theta, x_d, y_d, theta_d, delta = x.unbind(-1)
    p = params
    Fx = u[..., 0]

    # the plant regularises slip angles with +v_eps, not with the
    # exponential softening of the curvilinear model
    xd_reg = x_d + p.v_eps
    alpha_f = delta - torch.arctan((y_d + p.lf * theta_d) / xd_reg)
    alpha_r = -torch.arctan((y_d - p.lr * theta_d) / xd_reg)

    Fzf = p.m * p.g * p.lr / (p.lr + p.lf)
    Fzr = p.m * p.g * p.lf / (p.lr + p.lf)
    Fcf = Fzf * pacejka(alpha_f, p)
    Fcr = Fzr * pacejka(alpha_r, p)

    return torch.stack([
        x_d * torch.cos(theta) - y_d * torch.sin(theta),
        x_d * torch.sin(theta) + y_d * torch.cos(theta),
        theta_d,
        (Fx - Fcf * torch.sin(delta) + p.m * y_d * theta_d) / p.m,
        (Fcr + Fcf * torch.cos(delta) - p.m * x_d * theta_d) / p.m,
        (p.lf * Fcf * torch.cos(delta) - p.lr * Fcr) / p.Iz,
        u[..., 1],
    ], -1)


def integrate_cart_dyn(x, u, dt, params: VehicleParams = VehicleParams()):
    """One RK6 step of the dynamic plant."""
    return rk6_step(lambda xx, uu: f_cart_dyn(xx, uu, params), x, u, dt)


def kinematic_bicycle(x, u, dt, params: VehicleParams = VehicleParams()):
    """One RK6 step of the kinematic bicycle."""
    return rk6_step(lambda xx, uu: f_cart_kin(xx, uu, params), x, u, dt)


def kinematic_bicycle_horizon(x0, u_traj, dt,
                              params: VehicleParams = VehicleParams()):
    """Sequential rollout of the kinematic bicycle over a control
    trajectory ``u_traj`` (..., N, 2); returns (..., N+1, 5) including the
    initial state."""
    xs = [x0]
    for k in range(u_traj.shape[-2]):
        xs.append(kinematic_bicycle(xs[-1], u_traj[..., k, :], dt, params))
    return torch.stack(xs, -2)
