"""Stage constraint groups of the curvilinear MPC controllers (port of
``fsae_mpc_tpu.mpc.constraints``).

Each physical constraint is a per-instance stage function
``g(x, u, *data)``; its rows come from ``torch.func.jacfwd`` batched with
``vmap`` over every leading dimension of the linearisation points, the
vehicle parameters mapped with the batch where they are per instance
(``models.instances``).  A group is a batch of affine rows

    lb <= offset_const_i + C_i x_{state_rows[i]} + D_i u_{ctrl_cols[i]}
          + sign * sigma_{slack_idx}  <= ub

``lb/ub/slack_idx/state_rows/ctrl_cols`` are static numpy: they define the
QP row structure and are the same for every instance of a batch.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch
from torch.func import jacfwd

from ..config import MPCParams, VehicleParams
from ..models import curvilinear as cm
from ..models.instances import vmap_instances


@dataclasses.dataclass(frozen=True)
class StageConstraint:
    C: torch.Tensor            # (..., Ng, r, nx)
    D: torch.Tensor            # (..., Ng, r, nu)
    offset_const: torch.Tensor  # (..., Ng, r)
    lb: np.ndarray             # (r,) static
    ub: np.ndarray             # (r,) static
    slack_idx: np.ndarray      # (r,) static; -1 = hard row
    state_rows: np.ndarray     # (Ng,) static; -1 = fixed x0
    ctrl_cols: np.ndarray      # (Ng,) static; -1 = no control column


def linearize_group(g_fn: Callable, x_lin, u_lin, lb, ub, slack_idx,
                    state_rows=None, ctrl_cols=None, data=()):
    """Build a StageConstraint from a per-instance vector stage function
    ``g_fn(x, u, *data)``.

    ``x_lin/u_lin``: (..., Ng, nx)/(..., Ng, nu) linearisation points
    matching ``state_rows``/``ctrl_cols`` (defaults: 0..Ng-1).
    """
    nx, nu = x_lin.shape[-1], u_lin.shape[-1]

    def one(x, u, *d):
        g = lambda xx, uu: g_fn(xx, uu, *d)
        # see models.integrators.linearize_discrete on the dtype casts
        g0 = g(x, u).reshape(-1).to(x.dtype)
        C = jacfwd(g, argnums=0)(x, u).reshape(-1, nx).to(x.dtype)
        D = jacfwd(g, argnums=1)(x, u).reshape(-1, nu).to(x.dtype)
        return g0, C, D

    g0, C, D = vmap_instances(one, (x_lin, u_lin), x_lin.ndim - 1, data)
    offset_const = (g0 - torch.einsum("...ri,...i->...r", C, x_lin)
                    - torch.einsum("...ri,...i->...r", D, u_lin))
    Ng = x_lin.shape[-2]
    if state_rows is None:
        state_rows = np.arange(Ng)
    if ctrl_cols is None:
        ctrl_cols = np.arange(Ng)
    return StageConstraint(
        C=C, D=D, offset_const=offset_const,
        lb=np.atleast_1d(np.asarray(lb, np.float64)),
        ub=np.atleast_1d(np.asarray(ub, np.float64)),
        slack_idx=np.atleast_1d(np.asarray(slack_idx, np.int32)),
        state_rows=np.asarray(state_rows, np.int32),
        ctrl_cols=np.asarray(ctrl_cols, np.int32))


def state_box_group(idx, lb, ub, slack_idx, x_lin, u_lin, state_rows=None):
    """Box constraints on selected state components (hard or soft)."""
    sel = [int(i) for i in np.asarray(idx, np.int64)]

    def g(x, u):
        return torch.stack([x[i] for i in sel])

    return linearize_group(g, x_lin, u_lin, lb, ub, slack_idx,
                           state_rows=state_rows)


def kinematic_tyre_group(x_lin, u_lin, mpc: MPCParams, params: VehicleParams,
                         slack: int, state_rows=None):
    """Kinematic lateral-acceleration proxy |v^2 delta / (lr+lf)| <=
    ay_max."""
    def g(x, u, p):
        return (x[3] ** 2 * x[4] / (p.lr + p.lf))[None]

    return linearize_group(g, x_lin, u_lin, [-mpc.ay_max], [mpc.ay_max],
                           [slack], state_rows=state_rows, data=(params,))


def dynamic_slip_group(x_lin, u_lin, mpc: MPCParams, params: VehicleParams,
                       slack_rear: int, slack_front: int):
    """Slip-angle linear-region constraints |alpha_r|, |alpha_f| <= slip_max
    (row order rear, front)."""
    def g(x, u, p):
        q = cm.rear_slip_quantities(x, p)
        return torch.stack([q["alpha_r"], q["alpha_f"]])

    return linearize_group(
        g, x_lin, u_lin,
        [-mpc.slip_max, -mpc.slip_max], [mpc.slip_max, mpc.slip_max],
        [slack_rear, slack_front], data=(params,))


def friction_polygon_group(x_lin, u_lin, mpc: MPCParams,
                           params: VehicleParams, slack: int):
    """Friction ellipse outer-approximated by tangent lines at
    ``n_tyre_polygon`` points.  Row j:
    (u1 - al_j) dac_j - (Fcr/m - ac_j) dal_j <= 0."""
    K = mpc.n_tyre_polygon
    theta = torch.linspace(0.0, 2.0 * math.pi, K + 1, dtype=x_lin.dtype,
                           device=x_lin.device)

    def g(x, u, p):
        # the polygon's vertices are the instance's own ellipse's
        ac = p.ac_max * torch.sin(theta)
        al = p.al_max * torch.cos(theta)
        dac = ac[1:] - ac[:-1]
        dal = al[1:] - al[:-1]
        fcr_norm = cm.rear_lateral_force(x, p) / p.m
        return (u[0] - al[:-1]) * dac - (fcr_norm - ac[:-1]) * dal

    return linearize_group(g, x_lin, u_lin,
                           np.full((K,), -np.inf), np.zeros((K,)),
                           np.full((K,), slack, np.int32), data=(params,))


def friction_ellipse_group(x_lin, u_lin, mpc: MPCParams,
                           params: VehicleParams, slack: int,
                           state_rows=None, ctrl_cols=None):
    """Exact (nonconvex) friction-ellipse row of the SQP transcriptions:
    (Fcr/(m ac_max))^2 + (u1/al_max)^2 <= 1 + sigma.  The NMPC callers
    place it on the pre-step state (``state_rows`` with -1 = the fixed
    x0)."""
    def g(x, u, p):
        fcr = cm.rear_lateral_force(x, p)
        return ((fcr / (p.m * p.ac_max)) ** 2 + (u[0] / p.al_max) ** 2)[None]

    return linearize_group(g, x_lin, u_lin, [-np.inf], [1.0], [slack],
                           state_rows=state_rows, ctrl_cols=ctrl_cols,
                           data=(params,))


def friction_ellipse_value(fcr, fx_per_m, params: VehicleParams):
    """Exact friction-ellipse utilisation (Fcr/(m ac_max))^2 +
    (a/al_max)^2."""
    return ((fcr / (params.m * params.ac_max)) ** 2
            + (fx_per_m / params.al_max) ** 2)
