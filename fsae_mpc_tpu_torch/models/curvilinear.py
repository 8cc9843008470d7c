"""Curvilinear-frame vehicle ODEs (port of
``fsae_mpc_tpu.models.curvilinear``).

Each model is written per instance -- ``x`` (nx,), ``u`` (nu,) -- so that
``torch.func.jacfwd`` and ``vmap`` give the Jacobians the JAX package gets
from ``jax.jacfwd``.  Curvature is evaluated at ``s.detach()`` (the
counterpart of ``lax.stop_gradient``): the reference's Jacobians treat
kappa(s) as locally constant.
"""

from __future__ import annotations

import torch

from ..config import VehicleParams


def f_curv_dyn(x, u, track, params: VehicleParams = VehicleParams()):
    """Dynamic (Pacejka) bicycle in curvilinear coordinates.

    State ``[s, n, mu, x_d, y_d, theta_d, delta]``, control
    ``[Fx/m, delta_d]``.  Returns ``(f, Fcr)`` with the rear lateral tyre
    force.
    """
    s, n, mu, x_d, y_d, theta_d, delta = x
    p = params
    Fx = u[0] * p.m

    x_d_hat = x_d + p.v_soft * torch.exp(-x_d / p.v_soft)

    k = track.curvature(s.detach())
    denom = 1.0 / (1.0 - n * k)

    alpha_f = delta - torch.arctan((y_d + p.lf * theta_d) / x_d_hat)
    alpha_r = -torch.arctan((y_d - p.lr * theta_d) / x_d_hat)

    Fzf = p.m * p.g * p.lr / (p.lr + p.lf)
    Fzr = p.m * p.g * p.lf / (p.lr + p.lf)
    Fcf = Fzf * pacejka(alpha_f, p)
    Fcr = Fzr * pacejka(alpha_r, p)

    s_dot = (x_d * torch.cos(mu) - y_d * torch.sin(mu)) * denom
    f = torch.stack([
        s_dot,
        x_d * torch.sin(mu) + y_d * torch.cos(mu),
        theta_d - s_dot * k,
        (Fx - Fcf * torch.sin(delta) + p.m * y_d * theta_d) / p.m,
        (Fcr + Fcf * torch.cos(delta) - p.m * x_d * theta_d) / p.m,
        (p.lf * Fcf * torch.cos(delta) - p.lr * Fcr) / p.Iz,
        u[1],
    ])
    return f, Fcr


def f_curv_dyn_only(x, u, track, params: VehicleParams = VehicleParams()):
    """``f_curv_dyn`` without the auxiliary tyre-force output."""
    return f_curv_dyn(x, u, track, params)[0]


def pacejka(alpha, p: VehicleParams):
    """Normalised Pacejka magic-formula lateral force; multiply by the
    axle normal load."""
    Ba = p.pB * alpha
    return p.pD * torch.sin(
        p.pC * torch.arctan(Ba - p.pE * (Ba - torch.arctan(Ba))))


def rear_slip_quantities(x, params: VehicleParams = VehicleParams()):
    """Intermediates shared by the slip/friction constraint rows."""
    _, _, _, x_d, y_d, theta_d, delta = x
    p = params
    x_d_hat = x_d + p.v_soft * torch.exp(-x_d / p.v_soft)
    vf = (y_d + p.lf * theta_d) / x_d_hat
    vr = (y_d - p.lr * theta_d) / x_d_hat
    return {"x_d_hat": x_d_hat, "vf": vf, "vr": vr,
            "alpha_f": delta - torch.arctan(vf),
            "alpha_r": -torch.arctan(vr)}


def rear_lateral_force(x, params: VehicleParams = VehicleParams()):
    """Rear lateral tyre force Fcr(x) as a standalone scalar."""
    q = rear_slip_quantities(x, params)
    Fzr = params.m * params.g * params.lf / (params.lr + params.lf)
    return Fzr * pacejka(q["alpha_r"], params)
