"""SQP-based nonlinear MPC, multiple shooting, batch-first (port of
``fsae_mpc_tpu.mpc.sqp``).

Per NMPC tick and instance of the batch, ``sqp_iters`` times:

    linearise the shooting step at the current iterate (``torch.func``)
    -> dense backend: condense the states out (``ltv.CONDENSERS``: the
       hand-written kernel on the card) and solve the condensed QP with
       the dense IPM; Riccati backend: assemble the stage-wise QP and
       solve it with the block-Riccati IPM
    -> take the full step; the next subproblem is warm-started from this
       one's solution.

The first subproblem of a tick takes ``warm`` (``None``: a cold start,
which on the Riccati backend runs the plain factor sweep once).  Soft
slacks keep every subproblem feasible.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import MPCParams, VehicleParams
from ..models import curvilinear as cm
from ..models import integrators
from ..models.instances import vmap_instances
from ..ops import ipm
from ..ops import riccati
from ..ops.condense import rollout
from . import constraints as cons
from .ltv import (CONDENSERS, DEFAULT_CONDENSE, _const, _control_bounds,
                  assemble_condensed_qp, build_stage_qp)


@dataclasses.dataclass(frozen=True)
class SqpResult:
    x_opt: torch.Tensor    # (B, N, nx) state trajectory (N+1 points for
                           # collocation, point 0 = x0)
    u_opt: torch.Tensor    # (B, NC, nu) control trajectory
    slack: torch.Tensor    # (B, n_soft)
    fval: torch.Tensor     # (B,) objective of the last subproblem, with
                           # the constant the QP drops
    qp: ipm.IpmResult | riccati.StageIpmResult   # the last subproblem's


def run_sqp(sqp_iter, x_init, u_init, sqp_iters: int, warm):
    """The SQP loop.  ``sqp_iter((x_lin, u_lin), warm)`` solves one
    convex subproblem (``warm``: the solver result of the previous one, or
    ``None`` for a cold start) and returns ``((x_new, u_new), (slack,
    fval, res))``.  The first subproblem takes ``warm``, each later one is
    warm-started from its predecessor.  Returns ``(x_opt, u_opt, (slack,
    fval, res))`` of the last iterate."""
    carry, out = sqp_iter((x_init, u_init), warm)
    for _ in range(sqp_iters - 1):
        carry, out = sqp_iter(carry, out[2])
    return carry[0], carry[1], out


def shift_trajectory(x_opt, u_opt, step_fn, data=()):
    """Warm-start shift of a batch: drop the first stage, roll the last
    stage forward one step of ``step_fn`` (per instance: ``x`` (nx,),
    ``u`` (nu,), then ``*data``, mapped where it is per instance)."""
    x_last = vmap_instances(step_fn, (x_opt[:, -1], u_opt[:, -1]), 1, data)
    return (torch.cat([x_opt[:, 1:], x_last[:, None]], 1),
            torch.cat([u_opt[:, 1:], u_opt[:, -1:]], 1))


def _nmpc_weights(mpc: MPCParams, nx, N, dtype, device):
    """Diagonal tracking weights (N*nx,), the last stage's scaled by
    ``q_terminal_scale``, and control weights (N*nu,)."""
    q = np.zeros(nx)
    q[:3] = [mpc.q_s, mpc.q_n, mpc.q_mu]
    q_diag = np.concatenate([np.tile(q, N - 1), q * mpc.q_terminal_scale])
    r_diag = np.tile([mpc.r_a, mpc.r_delta_d], N)
    return _const(q_diag, dtype, device), _const(r_diag, dtype, device)


def _align_prestep_group(grp, Ad, Bd, dd, x0):
    """Re-express a pre-step-state constraint group in the stage-aligned
    basis of the stage-wise Riccati solver, exactly.

    The MS-NMPC friction rows constrain the step's ORIGIN state with the
    step's control (row k touches (x_k, u_k); ``state_rows = [-1,
    0..N-2]``), while the stage solver's rows read C x_{k+1} + D u_k.
    Substituting the QP-exact dynamics x_k = Ad_k^{-1} (x_{k+1} - Bd_k u_k
    - dd_k) gives the same affine row on (x_{k+1}, u_k):

        C' = C Ad^{-1},  D' = D - C' Bd,  offset' = offset - C' dd.

    Row 0's origin state is the fixed x0, so its C row folds into the
    offset.  The feasible set is unchanged, so the stage QP's minimiser is
    the condensed QP's.  ``torch.linalg.solve_ex``: no error check, so no
    host synchronisation on the card (a singular Ad gives non-finite rows,
    which the IPM rejects per instance).
    """
    N = Ad.shape[1]
    if not (np.array_equal(grp.state_rows,
                           np.concatenate([[-1], np.arange(N - 1)]))
            and np.array_equal(grp.ctrl_cols, np.arange(N))):
        raise ValueError("_align_prestep_group expects rows on the "
                         "pre-step state: state_rows = [-1, 0..N-2]")
    Cp = torch.linalg.solve_ex(Ad.mT, grp.C.mT)[0].mT       # (B, N, r, nx)
    Dp = grp.D - torch.einsum("bnri,bnik->bnrk", Cp, Bd)
    off = grp.offset_const - torch.einsum("bnri,bni->bnr", Cp, dd)
    Cp = torch.cat([torch.zeros_like(Cp[:, :1]), Cp[:, 1:]], 1)
    Dp = torch.cat([grp.D[:, :1], Dp[:, 1:]], 1)
    off = torch.cat([(grp.offset_const[:, 0]
                      + torch.einsum("bri,bi->br", grp.C[:, 0], x0))[:, None],
                     off[:, 1:]], 1)
    return dataclasses.replace(
        grp, C=Cp, D=Dp, offset_const=off,
        state_rows=np.arange(N, dtype=np.int32),
        ctrl_cols=np.arange(N, dtype=np.int32))


def _check_backend(backend: str) -> None:
    if backend not in ("dense", "riccati"):
        raise ValueError(f"unknown backend={backend!r}")


def _ms_nmpc(x0, x_ref, f, data, nx, groups_of, r_soft, u_lb, u_ub, mpc,
             x_init, u_init, opts, stepper, sqp_iters, warm, backend,
             trust_u=None, align=None):
    """The multiple-shooting SQP of both models on the ODE ``f(x, u,
    *data)``: the step is linearised at its ORIGIN state (``x_pre``), so
    the defects carry no fixed-point bias; ``groups_of(x_lin, u_lin,
    x_pre)`` gives the constraint groups; ``align``: the index of a
    pre-step group that the Riccati backend re-expresses on the stage's
    post-state."""
    _check_backend(backend)
    N = mpc.n_steps
    dtype, dev = x_init.dtype, x_init.device
    step = integrators.discrete_step(f, stepper, mpc.dt)
    q_diag, r_diag = _nmpc_weights(mpc, nx, N, dtype, dev)
    q_vec, r_ab = q_diag[:nx], r_diag[:2]
    tr = None if trust_u is None else _const(trust_u, dtype, dev)

    def sqp_iter(carry, qp_warm):
        x_lin, u_lin = carry
        x_pre = torch.cat([x0[:, None], x_lin[:, :-1]], 1)
        Ad, Bd, dd = integrators.linearize_discrete(step, x_pre, u_lin,
                                                    data)
        groups = groups_of(x_lin, u_lin, x_pre)
        lb, ub = u_lb, u_ub
        if tr is not None:
            lb = torch.maximum(u_lb, u_lin - tr)
            ub = torch.minimum(u_ub, u_lin + tr)
        if backend == "riccati":
            if align is not None:
                groups[align] = _align_prestep_group(groups[align], Ad, Bd,
                                                     dd, x0)
            qp_s, const = build_stage_qp(x0, x_ref, q_vec, r_ab, r_soft,
                                         groups, mpc, Ad, Bd, dd, lb, ub)
            res = riccati.solve_stage_qp(qp_s, opts, warm=qp_warm)
            u_new = res.u
            return ((rollout(Ad, Bd, dd, x0, u_new), u_new),
                    (res.s, res.objective + const, res))
        A_bar, B_bar, d_bar = CONDENSERS[DEFAULT_CONDENSE](
            Ad.contiguous(), Bd.contiguous(), dd.contiguous())
        H, g, A, lbv, ubv, lbA, ubA, const = assemble_condensed_qp(
            A_bar, B_bar, d_bar, x0, x_ref, q_diag, r_diag, r_soft, groups,
            lb, ub)
        res = ipm.solve_qp(H, g, A, lbv, ubv, lbA, ubA, opts, warm=qp_warm)
        u_new = res.x[:, :N * 2].reshape(-1, N, 2)
        return ((rollout(Ad, Bd, dd, x0, u_new), u_new),
                (res.x[:, N * 2:], res.objective + const, res))

    x_opt, u_opt, last = run_sqp(sqp_iter, x_init, u_init, sqp_iters, warm)
    return SqpResult(x_opt=x_opt, u_opt=u_opt, slack=last[0], fval=last[1],
                     qp=last[2])


def ms_nmpc_kinematic(x0, x_ref, track, params: VehicleParams,
                      mpc: MPCParams, x_init, u_init,
                      opts: ipm.IpmOptions = ipm.IpmOptions(),
                      stepper: str = "rk2", sqp_iters: int = 3,
                      warm=None, backend: str = "dense") -> SqpResult:
    """A batch of multiple-shooting NMPC ticks, kinematic model.

    Tracking weights Q = [q_s, q_n, q_mu, 0, 0] (terminal x
    ``q_terminal_scale``), R = [r_a, r_delta_d]; the shooting defects of
    ``stepper`` eliminated by condensing (dense) or kept as the stage
    dynamics (Riccati); |n| <= n_max and the lateral-acceleration proxy
    softened by one shared slack.  ``x0`` (B, 5), ``x_ref`` (B, N, 5);
    ``x_init``/``u_init`` (B, N, 5)/(B, N, 2): the SQP's starting
    trajectory (:func:`shift_trajectory` across ticks).  The rows are
    stage-aligned, so both backends solve the same subproblem.
    """
    u_lb, u_ub = _control_bounds(mpc, x0.shape[0], mpc.n_steps,
                                 x_init.dtype, x_init.device)

    def groups_of(x_lin, u_lin, x_pre):
        return [
            cons.state_box_group([3, 4], np.array([0.0, -mpc.delta_max]),
                                 np.array([np.inf, mpc.delta_max]),
                                 np.array([-1, -1]), x_lin, u_lin),
            cons.state_box_group([1], np.array([-mpc.n_max]),
                                 np.array([mpc.n_max]), np.array([0]),
                                 x_lin, u_lin),
            cons.kinematic_tyre_group(x_lin, u_lin, mpc, params, slack=0),
        ]

    return _ms_nmpc(x0, x_ref, cm.f_curv_kin, (track, params), 5, groups_of,
                    [mpc.w_track], u_lb, u_ub, mpc, x_init, u_init, opts,
                    stepper, sqp_iters, warm, backend)


def ms_nmpc_dynamic(x0, x_ref, track, params: VehicleParams,
                    mpc: MPCParams, x_init, u_init,
                    opts: ipm.IpmOptions = ipm.IpmOptions(),
                    stepper: str = "rk2", sqp_iters: int = 3,
                    trust_u=(4.0, 0.3), warm=None,
                    backend: str = "dense") -> SqpResult:
    """A batch of multiple-shooting NMPC ticks, dynamic model.

    The exact friction ellipse (Fcr/(m ac))^2 + (a/al)^2 <= 1 + sigma on
    the PRE-step state with the step's control, track softening w_track,
    tyre softening w_slip, acceleration unbounded (the ellipse bounds
    it); slacks [track, tyre].  ``trust_u``: a per-component trust region
    |u - u_lin| <= trust_u of the subproblem, inactive at the SQP's fixed
    point.  On the Riccati backend the friction rows are re-expressed on
    the stage's post-state (:func:`_align_prestep_group`): the same
    subproblem.  Shapes as :func:`ms_nmpc_kinematic` with nx = 7.
    """
    N = mpc.n_steps
    Bsz, dtype, dev = x0.shape[0], x_init.dtype, x_init.device
    u_lb = _const([-np.inf, -mpc.delta_d_max], dtype, dev).repeat(Bsz, N, 1)
    u_ub = _const([np.inf, mpc.delta_d_max], dtype, dev).repeat(Bsz, N, 1)
    pre_rows = np.concatenate([[-1], np.arange(N - 1)])

    def groups_of(x_lin, u_lin, x_pre):
        return [
            cons.state_box_group([3, 6], np.array([0.0, -mpc.delta_max]),
                                 np.array([np.inf, mpc.delta_max]),
                                 np.array([-1, -1]), x_lin, u_lin),
            cons.state_box_group([1], np.array([-mpc.n_max]),
                                 np.array([mpc.n_max]), np.array([0]),
                                 x_lin, u_lin),
            cons.friction_ellipse_group(x_pre, u_lin, mpc, params, slack=1,
                                        state_rows=pre_rows),
        ]

    return _ms_nmpc(x0, x_ref, cm.f_curv_dyn_only, (track, params), 7,
                    groups_of, [mpc.w_track, mpc.w_slip], u_lb, u_ub, mpc,
                    x_init, u_init, opts, stepper, sqp_iters, warm, backend,
                    trust_u=trust_u, align=2)
