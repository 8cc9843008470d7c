"""Dynamic-model LTV-MPC tick on the stage-wise Riccati solver (port of the
stage path of ``fsae_mpc_tpu.mpc.ltv``; the condensed dense path, the
kinematic controller and the planners are not ported yet).

Per tick and per instance of the batch: linearise the RK4 step of the
curvilinear dynamic model along the previous trajectory, build the
slip/friction/track constraint rows, assemble the uncondensed
:class:`ops.riccati.StageQP` and solve it.  Every tensor carries a leading
batch dimension B.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from ..config import MPCParams, VehicleParams
from ..models import curvilinear as cm
from ..models import integrators
from ..ops import ipm
from ..ops import riccati
from . import constraints as cons


def _const(values, dtype, device) -> torch.Tensor:
    """A constant of the QP's structure (bounds, weights, slack pattern),
    made on the host and copied to ``device`` from pinned memory without
    waiting for the device, so that building a tick never synchronises
    with the host."""
    t = torch.tensor(np.array(values, np.float64), dtype=dtype)
    if torch.device(device).type == "cuda":
        t = t.pin_memory().to(device, non_blocking=True)
    return t


@dataclasses.dataclass(frozen=True)
class LtvResult:
    u_opt: torch.Tensor     # (B, N, nu) optimal control trajectory
    x_opt: torch.Tensor     # (B, N, nx) predicted optimal states
    slack: torch.Tensor     # (B, n_soft) slack values
    fval: torch.Tensor      # (B,) objective incl. the constant the QP drops
    qp: riccati.StageIpmResult


def build_stage_rows(groups, N, nx, nu, n_soft, dtype):
    """Emit stage-aligned constraint groups as per-stage row tensors.

    Returns (C (B, N, r, nx), D (B, N, r, nu), Ws (B, N, r, ns),
    lbA (B, N, r), ubA (B, N, r)) with rows
    lbA <= C x_{k+1} + D u_k + Ws sigma <= ubA on absolute states (the
    group's linearisation constant folded into the bounds).  Soft
    two-sided groups emit separate lower(+sigma)/upper(-sigma) rows.
    Every group must be stage-aligned (state_rows == ctrl_cols ==
    arange(N)).
    """
    Bsz, dev = groups[0].C.shape[0], groups[0].C.device
    C_parts, D_parts, Ws_parts, lo_parts, hi_parts = [], [], [], [], []

    def emit(C, D, off, lo, hi, slack_col, sign):
        rr = C.shape[-2]
        Ws = np.zeros((rr, n_soft), np.float64)
        if slack_col is not None:
            Ws[np.arange(rr), slack_col] = sign
        C_parts.append(C)
        D_parts.append(D)
        Ws_parts.append(_const(Ws, dtype, dev).expand(Bsz, N, rr, n_soft))
        lo_parts.append(_const(lo, dtype, dev) - off)
        hi_parts.append(_const(hi, dtype, dev) - off)

    for grp in groups:
        Ng, rr = grp.C.shape[-3], grp.C.shape[-2]
        if (Ng != N or not np.array_equal(grp.state_rows, np.arange(N))
                or not np.array_equal(grp.ctrl_cols, np.arange(N))):
            raise ValueError("stage-QP assembly requires stage-aligned "
                             "groups")
        lb_g = np.broadcast_to(grp.lb, (rr,))
        ub_g = np.broadcast_to(grp.ub, (rr,))
        sidx = np.broadcast_to(grp.slack_idx, (rr,))
        hard = sidx < 0
        if np.all(hard):
            emit(grp.C, grp.D, grp.offset_const, lb_g, ub_g, None, 0.0)
        else:
            if np.any(hard):
                raise ValueError("mix of hard/soft rows within a group")
            inf_v = np.full((rr,), np.inf)
            if np.all(np.isfinite(lb_g)):
                emit(grp.C, grp.D, grp.offset_const, lb_g, inf_v, sidx,
                     +1.0)
            if np.all(np.isfinite(ub_g)):
                emit(grp.C, grp.D, grp.offset_const, -inf_v, ub_g, sidx,
                     -1.0)

    return (torch.cat(C_parts, -2), torch.cat(D_parts, -2),
            torch.cat(Ws_parts, -2), torch.cat(lo_parts, -1),
            torch.cat(hi_parts, -1))


def _stage_cost(x_ref, q, r_ab, mpc, N, dtype):
    """Per-stage diagonal costs: Qx = 2 q_k, qx = -2 q_k xref_k, Ru = 2 R.
    Returns (Qx, qx, Ru, const) with ``const`` (B,) the dropped constant
    sum_k xref' q_k xref."""
    Bsz = x_ref.shape[0]
    q_stage = torch.cat([q[None].repeat(N - 1, 1),
                         (q * mpc.q_terminal_scale)[None]], 0)    # (N, nx)
    Qx = (2.0 * q_stage).repeat(Bsz, 1, 1)
    qx = -2.0 * q_stage * x_ref
    Ru = (2.0 * r_ab).repeat(Bsz, N, 1)
    const = (q_stage * x_ref * x_ref).reshape(Bsz, -1).sum(1)
    return Qx, qx, Ru, const


def build_stage_qp(x0, x_ref, q, r_ab, r_soft: Sequence[float], groups,
                   mpc: MPCParams, Ad, Bd, dd, u_lb, u_ub):
    """Assemble a :class:`ops.riccati.StageQP` batch from the discrete
    linearisation + stage-aligned constraint groups."""
    Bsz, N, nx, nu = Bd.shape
    n_soft = len(r_soft)
    dtype, dev = Bd.dtype, Bd.device
    Qx, qx, Ru, const = _stage_cost(x_ref, q, r_ab, mpc, N, dtype)
    C, D, Ws, lbA, ubA = build_stage_rows(groups, N, nx, nu, n_soft, dtype)
    zeros_s = torch.zeros((Bsz, n_soft), dtype=dtype, device=dev)
    qp = riccati.StageQP(
        Ad=Ad, Bd=Bd, dd=dd, x0=x0, Qx=Qx, qx=qx, Ru=Ru,
        ru=torch.zeros((Bsz, N, nu), dtype=dtype, device=dev),
        g_s=_const(r_soft, dtype, dev).repeat(Bsz, 1),
        C=C, D=D, Ws=Ws, lbA=lbA, ubA=ubA,
        u_lb=u_lb, u_ub=u_ub,
        s_lb=zeros_s, s_ub=torch.full_like(zeros_s, float("inf")))
    return qp, const


def _control_bounds(mpc: MPCParams, Bsz, N, dtype, device):
    u_lb = _const([-mpc.a_max, -mpc.delta_d_max], dtype,
                  device).repeat(Bsz, N, 1)
    u_ub = _const([mpc.a_max, mpc.delta_d_max], dtype,
                  device).repeat(Bsz, N, 1)
    return u_lb, u_ub


def _dynamic_groups(x_lin, u_lin, mpc, params):
    return [
        cons.state_box_group([3, 6],
                             np.array([0.0, -mpc.delta_max]),
                             np.array([np.inf, mpc.delta_max]),
                             np.array([-1, -1]), x_lin, u_lin),
        cons.state_box_group([1], np.array([-mpc.n_max]),
                             np.array([mpc.n_max]), np.array([0]),
                             x_lin, u_lin),
        cons.dynamic_slip_group(x_lin, u_lin, mpc, params,
                                slack_rear=1, slack_front=2),
        cons.friction_polygon_group(x_lin, u_lin, mpc, params, slack=3),
    ]


def build_stage_qp_dynamic(x0, x_ref, track, params: VehicleParams,
                           mpc: MPCParams, x_lin, u_lin,
                           stepper: str = "rk4"):
    """Assemble a batch of dynamic-model LTV ticks as uncondensed
    :class:`ops.riccati.StageQP`s.  ``x0`` (B, 7), ``x_ref``/``x_lin``
    (B, N, 7), ``u_lin`` (B, N, 2).  Returns (qp, const)."""
    dtype, dev = x_lin.dtype, x_lin.device
    Bsz = x_lin.shape[0]
    f = lambda x, u: cm.f_curv_dyn_only(x, u, track, params)
    step = lambda x, u: integrators.STEPPERS[stepper](f, x, u, mpc.dt)
    Ad, Bd, dd = integrators.linearize_discrete(step, x_lin, u_lin)
    q = _const([mpc.q_s, mpc.q_n, mpc.q_mu, 0.0, 0.0, 0.0, 0.0], dtype, dev)
    r_ab = _const([mpc.r_a, mpc.r_delta_d], dtype, dev)
    groups = _dynamic_groups(x_lin, u_lin, mpc, params)
    u_lb, u_ub = _control_bounds(mpc, Bsz, mpc.n_steps, dtype, dev)
    r_soft = [mpc.w_track, mpc.w_slip, mpc.w_slip, mpc.w_tyre]
    return build_stage_qp(x0, x_ref, q, r_ab, r_soft, groups, mpc,
                          Ad, Bd, dd, u_lb, u_ub)


def ltv_mpc_dynamic_riccati(x0, x_ref, track, params: VehicleParams,
                            mpc: MPCParams, x_lin, u_lin,
                            opts: ipm.IpmOptions = ipm.IpmOptions(),
                            stepper: str = "rk4",
                            warm: riccati.StageIpmResult | None = None
                            ) -> LtvResult:
    """A batch of dynamic-model LTV-MPC ticks on the stage-wise Riccati
    solver.  ``warm`` is the :class:`ops.riccati.StageIpmResult` of the
    previous tick (``LtvResult.qp``)."""
    qp, const = build_stage_qp_dynamic(x0, x_ref, track, params, mpc,
                                       x_lin, u_lin, stepper)
    res = riccati.solve_stage_qp(qp, opts, warm=warm)
    return LtvResult(u_opt=res.u, x_opt=res.x, slack=res.s,
                     fval=res.objective + const, qp=res)
