"""LTV-MPC ticks of the dynamic and the kinematic model (port of
``fsae_mpc_tpu.mpc.ltv``).

Per tick and per instance of the batch: linearise the discrete step of
the curvilinear model (dynamic: RK4, with slip, friction-polygon and
track rows; kinematic: RK2, with the lateral-acceleration proxy and the
track row) along the previous trajectory, then either

  * (``backend="dense"``, the default) condense the horizon
    (``CONDENSERS``), assemble the condensed QP over the N*nu controls and
    the slacks (:func:`assemble_condensed_qp`), solve it with the dense
    IPM (``ops/ipm.py``) and roll the states out; or
  * (``backend="riccati"``) assemble the uncondensed
    :class:`ops.riccati.StageQP` and solve it stage-wise.

Both solve the same QP.  Every tensor carries a leading batch dimension B.
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
from ..ops.condense import condense as _condense
from ..ops.condense import rollout as _rollout
from ..ops.kernels import condense as _kcondense
from ..ops.precision import highest as _highest_precision
from . import constraints as cons

# Condensing backends: "pallas" names the hand-written kernel
# (``ops/kernels/condense.py``: the kernel on CUDA tensors, its plain
# version on CPU tensors), "scan" the plain loop over stages.  The JAX
# package's "dnc" (divide and conquer, a TPU-measured variant) is not
# ported and raises.
CONDENSERS = {"scan": _condense, "pallas": _kcondense.condense}
DEFAULT_CONDENSE = "pallas"


def _const(values, dtype, device) -> torch.Tensor:
    """A constant of the QP's structure (bounds, weights, slack pattern),
    made on the host and copied to ``device`` from pinned memory without
    waiting for the device, so that building a tick never synchronises
    with the host."""
    t = torch.tensor(np.array(values, np.float64), dtype=dtype)
    if torch.device(device).type == "cuda":
        t = t.pin_memory().to(device, non_blocking=True)
    return t


def _const_index(values, device) -> torch.Tensor:
    """A static index vector, copied to ``device`` as :func:`_const`
    copies a constant (no host synchronisation)."""
    t = torch.tensor(np.asarray(values, np.int64))
    if torch.device(device).type == "cuda":
        t = t.pin_memory().to(device, non_blocking=True)
    return t


@dataclasses.dataclass(frozen=True)
class LtvResult:
    u_opt: torch.Tensor     # (B, N, nu) optimal control trajectory
    x_opt: torch.Tensor     # (B, N, nx) predicted optimal states
    slack: torch.Tensor     # (B, n_soft) slack values
    fval: torch.Tensor      # (B,) objective incl. the constant the QP drops
    qp: ipm.IpmResult | riccati.StageIpmResult


@_highest_precision
def _qp_cost(A_bar, B_bar, d_bar, x0, x_ref, q_diag, r_diag,
             r_soft: Sequence[float], u_lb, u_ub):
    """Shared cost/bounds assembly of the condensed QP
    (``generate_qp.m:29-33``).  ``q_diag`` (N*nx,), ``r_diag`` (NC*nu,)."""
    Bsz, N, nx, ncu = B_bar.shape
    n_soft = len(r_soft)
    nv = ncu + n_soft
    dtype, dev = B_bar.dtype, B_bar.device

    B_flat = B_bar.reshape(Bsz, N * nx, ncu)
    x_pred = torch.einsum("bnij,bj->bni", A_bar, x0) + d_bar    # (B, N, nx)
    err = (x_pred - x_ref).reshape(Bsz, -1)

    QB = B_flat * q_diag[:, None]
    Hu = 2.0 * (B_flat.mT @ QB)
    Hu = Hu + torch.diag_embed(2.0 * r_diag)
    H = torch.zeros((Bsz, nv, nv), dtype=dtype, device=dev)
    H[:, :ncu, :ncu] = Hu
    g = torch.cat([2.0 * torch.einsum("bkj,bk->bj", QB, err),
                   _const(r_soft, dtype, dev).expand(Bsz, n_soft)], 1)
    const = (err * (q_diag * err)).sum(1)

    lb_v = torch.cat([u_lb.reshape(Bsz, -1),
                      torch.zeros((Bsz, n_soft), dtype=dtype, device=dev)],
                     1)
    ub_v = torch.cat([u_ub.reshape(Bsz, -1),
                      torch.full((Bsz, n_soft), float("inf"), dtype=dtype,
                                 device=dev)], 1)
    return H, g, lb_v, ub_v, const, x_pred


def _aligned(groups, N) -> bool:
    return all(grp.C.shape[-3] == N
               and np.array_equal(grp.state_rows, np.arange(N))
               and np.array_equal(grp.ctrl_cols, np.arange(N))
               for grp in groups)


@_highest_precision
def assemble_condensed_qp(A_bar, B_bar, d_bar, x0, x_ref, q_diag, r_diag,
                          r_soft: Sequence[float], groups, u_lb, u_ub):
    """Assemble the condensed QP over v = [u_0..u_{NC-1}, sigma_1..sigma_k].

    ``B_bar``: (B, N, nx, NC*nu), NC >= N (collocation keeps one more
    control than states); ``q_diag`` (N*nx,), ``r_diag`` (NC*nu,);
    ``groups``: :class:`constraints.StageConstraint`s.  A group whose rows
    are stage-aligned (``state_rows == ctrl_cols == arange(N)``, every
    LTV group) goes through one fused product with the others; any other
    reads the predicted state ``state_rows`` (-1: the fixed x0) and places
    each stage's D into the control columns ``ctrl_cols`` (-1: none).
    Rows are group-major, each group's stage-major, a soft two-sided group
    emitting its lower (+sigma) rows and then its upper (-sigma) rows: the
    JAX package's order.  Returns (H, g, A, lb, ub, lbA, ubA, const).
    """
    Bsz, N, nx, ncu = B_bar.shape
    nu = u_lb.shape[-1]
    n_soft = len(r_soft)
    dtype, dev = B_bar.dtype, B_bar.device

    H, g, lb_v, ub_v, const, x_pred = _qp_cost(
        A_bar, B_bar, d_bar, x0, x_ref, q_diag, r_diag, r_soft, u_lb, u_ub)

    def placement(ccols):
        """Static one-hot projections (Ng, nu, NC*nu) of each stage's
        control into its columns (zero where ``ccols`` is -1)."""
        P = np.zeros((len(ccols), nu, ncu))
        for k, c in enumerate(ccols):
            if c >= 0:
                P[k, :, c * nu:(c + 1) * nu] = np.eye(nu)
        return _const(P, dtype, dev)

    aligned = ncu == N * nu and _aligned(groups, N)
    if aligned:
        # ONE fused (N, R_tot, nx) @ (N, nx, N*nu) product and one
        # block-diagonal D placement for all groups, then per-group slicing
        C_all = torch.cat([grp.C for grp in groups], -2)      # (B, N, R, nx)
        D_all = torch.cat([grp.D for grp in groups], -2)      # (B, N, R, nu)
        rows_all = (torch.einsum("bnri,bnij->bnrj", C_all, B_bar)
                    + torch.einsum("bnrk,nkj->bnrj", D_all,
                                   placement(np.arange(N))))
        off_all = (torch.cat([grp.offset_const for grp in groups], -1)
                   + torch.einsum("bnri,bni->bnr", C_all, x_pred))

    A_rows, lbA_rows, ubA_rows = [], [], []

    def emit(rows, off, lo, hi, slack_col, sign):
        s_cols = np.zeros((rows.shape[1], n_soft))
        if slack_col is not None:
            s_cols[np.arange(rows.shape[1]), slack_col] = sign
        A_rows.append(torch.cat(
            [rows, _const(s_cols, dtype, dev).expand(Bsz, -1, -1)], -1))
        lbA_rows.append(_const(lo, dtype, dev) - off)
        ubA_rows.append(_const(hi, dtype, dev) - off)

    r_off = 0
    for grp in groups:
        Ng, r = grp.C.shape[-3], grp.C.shape[-2]
        if aligned:
            rows_u = rows_all[:, :, r_off:r_off + r]
            offset = off_all[:, :, r_off:r_off + r]
            r_off += r
        else:
            srows, ccols = grp.state_rows, grp.ctrl_cols    # static (Ng,)
            # state sensitivity: the selected B_bar rows, 0 for fixed-x0
            # rows, whose state is x0 itself
            sel = _const_index(np.clip(srows, 0, N - 1), dev)
            free = _const(srows >= 0, dtype, dev) > 0
            B_sel = torch.where(free[:, None, None],
                                B_bar.index_select(1, sel), 0.0)
            x_sel = torch.where(free[:, None], x_pred.index_select(1, sel),
                                x0[:, None, :])
            rows_u = torch.einsum("bnri,bnij->bnrj", grp.C, B_sel)
            if np.any(ccols >= 0):
                rows_u = rows_u + torch.einsum("bnrk,nkj->bnrj", grp.D,
                                               placement(ccols))
            offset = (grp.offset_const
                      + torch.einsum("bnri,bni->bnr", grp.C, x_sel))
        rows_u = rows_u.reshape(Bsz, Ng * r, ncu)
        offset = offset.reshape(Bsz, Ng * r)
        lb_g = np.broadcast_to(grp.lb, (Ng, r)).reshape(-1)
        ub_g = np.broadcast_to(grp.ub, (Ng, r)).reshape(-1)
        sidx = np.broadcast_to(grp.slack_idx, (Ng, r)).reshape(-1)
        hard = sidx < 0
        if np.all(hard):
            emit(rows_u, offset, lb_g, ub_g, None, 0.0)
        else:
            if np.any(hard):
                raise ValueError("mix of hard/soft rows within a group")
            inf_v = np.full((len(lb_g),), np.inf)
            if np.all(np.isfinite(lb_g)):
                # lower side softened: g + sigma >= lb
                emit(rows_u, offset, lb_g, inf_v, sidx, +1.0)
            if np.all(np.isfinite(ub_g)):
                # upper side softened: g - sigma <= ub
                emit(rows_u, offset, -inf_v, ub_g, sidx, -1.0)

    return (H, g, torch.cat(A_rows, 1), lb_v, ub_v, torch.cat(lbA_rows, 1),
            torch.cat(ubA_rows, 1), const)


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


def _kinematic_groups(x_lin, u_lin, mpc, params):
    return [
        cons.state_box_group([3, 4],
                             np.array([0.0, -mpc.delta_max]),
                             np.array([np.inf, mpc.delta_max]),
                             np.array([-1, -1]), x_lin, u_lin),
        cons.state_box_group([1], np.array([-mpc.n_max]),
                             np.array([mpc.n_max]), np.array([0]),
                             x_lin, u_lin),
        cons.kinematic_tyre_group(x_lin, u_lin, mpc, params, slack=0),
    ]


# per model: the curvilinear ODE, the constraint groups and the slack
# weights (dynamic: track, rear slip, front slip, friction polygon;
# kinematic: track, shared by the lateral-acceleration rows)
_MODELS = {
    "dynamic": (cm.f_curv_dyn_only, _dynamic_groups,
                lambda mpc: [mpc.w_track, mpc.w_slip, mpc.w_slip,
                             mpc.w_tyre]),
    "kinematic": (cm.f_curv_kin, _kinematic_groups,
                  lambda mpc: [mpc.w_track]),
}


def _linearise(model: str, track, params: VehicleParams, mpc: MPCParams,
               x_lin, u_lin, stepper: str):
    """The tick's shared first layer: the discrete linearisation
    (Ad, Bd, dd), the cost weights q (nx,) and r_ab (nu,), the constraint
    groups, the control bounds and the slack weights."""
    f_curv, groups_of, r_soft = _MODELS[model]
    dtype, dev = x_lin.dtype, x_lin.device
    Bsz, nx = x_lin.shape[0], x_lin.shape[-1]
    Ad, Bd, dd = integrators.linearize_discrete(
        integrators.discrete_step(f_curv, stepper, mpc.dt), x_lin, u_lin,
        (track, params))
    q = _const([mpc.q_s, mpc.q_n, mpc.q_mu] + [0.0] * (nx - 3), dtype, dev)
    r_ab = _const([mpc.r_a, mpc.r_delta_d], dtype, dev)
    groups = groups_of(x_lin, u_lin, mpc, params)
    u_lb, u_ub = _control_bounds(mpc, Bsz, mpc.n_steps, dtype, dev)
    return Ad, Bd, dd, q, r_ab, groups, u_lb, u_ub, r_soft(mpc)


def _build_stage(model, x0, x_ref, track, params, mpc, x_lin, u_lin,
                 stepper):
    Ad, Bd, dd, q, r_ab, groups, u_lb, u_ub, r_soft = _linearise(
        model, track, params, mpc, x_lin, u_lin, stepper)
    return build_stage_qp(x0, x_ref, q, r_ab, r_soft, groups, mpc,
                          Ad, Bd, dd, u_lb, u_ub)


def _build_condensed(model, x0, x_ref, track, params, mpc, x_lin, u_lin,
                     stepper, condense):
    name = condense or DEFAULT_CONDENSE
    if name == "dnc":
        raise ValueError("condense='dnc' is not ported; use 'pallas' or "
                         "'scan'")
    N = mpc.n_steps
    Ad, Bd, dd, q, r_ab, groups, u_lb, u_ub, r_soft = _linearise(
        model, track, params, mpc, x_lin, u_lin, stepper)
    A_bar, B_bar, d_bar = CONDENSERS[name](
        Ad.contiguous(), Bd.contiguous(), dd.contiguous())
    q_diag = torch.cat([q.repeat(N - 1), q * mpc.q_terminal_scale])
    r_diag = r_ab.repeat(N)
    qp = assemble_condensed_qp(A_bar, B_bar, d_bar, x0, x_ref, q_diag,
                               r_diag, r_soft, groups, u_lb, u_ub)
    return qp, (Ad, Bd, dd)


def _ltv_tick(model, x0, x_ref, track, params, mpc, x_lin, u_lin, opts,
              stepper, warm, condense, backend) -> LtvResult:
    """One batch of LTV ticks of ``model`` on ``backend``."""
    if backend == "riccati":
        qp, const = _build_stage(model, x0, x_ref, track, params, mpc,
                                 x_lin, u_lin, stepper)
        res = riccati.solve_stage_qp(qp, opts, warm=warm)
        return LtvResult(u_opt=res.u, x_opt=res.x, slack=res.s,
                         fval=res.objective + const, qp=res)
    if backend != "dense":
        raise ValueError(f"unknown backend={backend!r}")
    N, nu = mpc.n_steps, 2
    (H, g, A, lb, ub, lbA, ubA, const), (Ad, Bd, dd) = _build_condensed(
        model, x0, x_ref, track, params, mpc, x_lin, u_lin, stepper,
        condense)
    res = ipm.solve_qp(H, g, A, lb, ub, lbA, ubA, opts, warm=warm)
    u_opt = res.x[:, :N * nu].reshape(-1, N, nu)
    x_opt = _rollout(Ad, Bd, dd, x0, u_opt)
    return LtvResult(u_opt=u_opt, x_opt=x_opt, slack=res.x[:, N * nu:],
                     fval=res.objective + const, qp=res)


def build_stage_qp_dynamic(x0, x_ref, track, params: VehicleParams,
                           mpc: MPCParams, x_lin, u_lin,
                           stepper: str = "rk4"):
    """Assemble a batch of dynamic-model LTV ticks as uncondensed
    :class:`ops.riccati.StageQP`s.  ``x0`` (B, 7), ``x_ref``/``x_lin``
    (B, N, 7), ``u_lin`` (B, N, 2).  Returns (qp, const)."""
    return _build_stage("dynamic", x0, x_ref, track, params, mpc, x_lin,
                        u_lin, stepper)


def ltv_mpc_dynamic_riccati(x0, x_ref, track, params: VehicleParams,
                            mpc: MPCParams, x_lin, u_lin,
                            opts: ipm.IpmOptions = ipm.IpmOptions(),
                            stepper: str = "rk4",
                            warm: riccati.StageIpmResult | None = None
                            ) -> LtvResult:
    """A batch of dynamic-model LTV-MPC ticks on the stage-wise Riccati
    solver.  ``warm`` is the :class:`ops.riccati.StageIpmResult` of the
    previous tick (``LtvResult.qp``)."""
    return _ltv_tick("dynamic", x0, x_ref, track, params, mpc, x_lin, u_lin,
                     opts, stepper, warm, None, "riccati")


def build_qp_dynamic(x0, x_ref, track, params: VehicleParams,
                     mpc: MPCParams, x_lin, u_lin, stepper: str = "rk4",
                     structured: bool = False, condense: str | None = None):
    """Assemble a batch of dynamic-model LTV ticks as condensed QPs.

    Returns ``((H, g, A, lb, ub, lbA, ubA, const), (Ad, Bd, dd))`` -- the
    condensed QPs plus the discrete linearisation (needed to recover the
    predicted states from the control solution).  The JAX package's
    generator-factored rows (``structured="gen"``) are not ported; any
    ``structured`` raises ``ValueError``.
    """
    _check_structured(structured)
    return _build_condensed("dynamic", x0, x_ref, track, params, mpc, x_lin,
                            u_lin, stepper, condense)


def _check_structured(structured):
    if structured:
        raise ValueError("structured constraint rows are not ported; use "
                         "the dense default")


def ltv_mpc_dynamic(x0, x_ref, track, params: VehicleParams,
                    mpc: MPCParams, x_lin, u_lin,
                    opts: ipm.IpmOptions = ipm.IpmOptions(),
                    stepper: str = "rk4", warm=None,
                    structured: bool = False,
                    condense: str | None = None,
                    backend: str = "dense") -> LtvResult:
    """A batch of dynamic-model LTV-MPC ticks.

    ``backend="dense"``: the condensed QP on the dense IPM; ``warm`` is
    the :class:`ops.ipm.IpmResult` of the previous tick.
    ``backend="riccati"``: :func:`ltv_mpc_dynamic_riccati` (``warm`` a
    :class:`ops.riccati.StageIpmResult`).  Both solve the same QP.
    """
    if backend == "dense":
        _check_structured(structured)
    return _ltv_tick("dynamic", x0, x_ref, track, params, mpc, x_lin, u_lin,
                     opts, stepper, warm, condense, backend)


def ltv_mpc_kinematic(x0, x_ref, track, params: VehicleParams,
                      mpc: MPCParams, x_lin, u_lin,
                      opts: ipm.IpmOptions = ipm.IpmOptions(),
                      stepper: str = "rk2", warm=None,
                      condense: str | None = None,
                      backend: str = "dense") -> LtvResult:
    """A batch of kinematic-model LTV-MPC ticks: weights
    Q = [q_s, q_n, q_mu, 0, 0], one track slack, the lateral-acceleration
    proxy rows.  ``x0`` (B, 5), ``x_ref``/``x_lin`` (B, N, 5), ``u_lin``
    (B, N, 2).  ``backend`` and ``warm`` as in :func:`ltv_mpc_dynamic`;
    the rows are stage-aligned, so both backends solve the same QP (dense:
    n = 2N+1 variables)."""
    return _ltv_tick("kinematic", x0, x_ref, track, params, mpc, x_lin,
                     u_lin, opts, stepper, warm, condense, backend)
