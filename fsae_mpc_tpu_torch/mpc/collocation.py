"""Direct-collocation NMPC, trapezoidal and Hermite-Simpson transcriptions,
batch-first (port of ``fsae_mpc_tpu.mpc.collocation``).

The knot states stay decision variables of the NLP; each SQP subproblem
linearises the implicit trapezoidal defect

    x_i - x_{i+1} + dt/2 (f_i + f_{i+1}) = 0

to the affine recurrence

    (I - dt/2 A_{i+1}) dx_{i+1} = (I + dt/2 A_i) dx_i
        + dt/2 (B_i du_i + B_{i+1} du_{i+1}) + r_i,

which couples two controls a step.  The dense backend condenses it with
``ops.condense.condense_general`` and solves the condensed QP over the
N+1 controls and the slacks; the Riccati backend solves it stage-wise on
the augmented state z_k = [x_k; u_k] (:func:`_trapezoidal_stage_qp`).

Hermite-Simpson (:func:`hs_nmpc_kinematic`, kinematic model, dense
backend only, as in the JAX package) keeps 2N+1 points at dt/2: the
midpoint-interpolation constraint is solved for each midpoint and
substituted into the Simpson defect, which leaves a knot recurrence
coupling three controls (u_2i, u_2i+1, u_2i+2), condensed with
``condense_general`` at stride 2, and an affine midpoint map.  Its
condensed QP has (2N+1) nu + 1 variables: 163 at N = 40, which the dense
Cholesky kernels take (n <= 192).
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import jacfwd

from ..config import MPCParams, VehicleParams
from ..models import curvilinear as cm
from ..models.instances import vmap_instances
from ..ops import ipm
from ..ops import riccati
from ..ops.condense import condense_general
from ..ops.linalg import column_blocks, solve_unrolled
from ..ops.precision import highest as _highest_precision
from . import constraints as cons
from .ltv import _const, assemble_condensed_qp
from .sqp import SqpResult, _check_backend, run_sqp


@_highest_precision
def _linearize_continuous(f, x_pts, u_pts, data=()):
    """The ODE ``f(x, u, *data)`` and its Jacobians A = df/dx, B = df/du
    at every point of ``x_pts`` (..., nx), ``u_pts`` (..., nu) (``data``
    mapped with the batch where it is per instance).  The tangents come
    back in the points' dtype (``torch.func``'s forward mode promotes a
    0-d tensor times a Python float to float64)."""
    def one(x, u, *d):
        fd = lambda xx, uu: f(xx, uu, *d)
        return (fd(x, u).to(x.dtype), jacfwd(fd, argnums=0)(x, u).to(x.dtype),
                jacfwd(fd, argnums=1)(x, u).to(x.dtype))

    return vmap_instances(one, (x_pts, u_pts), x_pts.ndim - 1, data)


@_highest_precision
def _trapezoidal_stages(f, x_pts, u_pts, dt, data=()):
    """The linearised trapezoidal recurrence in absolute coordinates.

    ``x_pts`` (B, N+1, nx): the iterate including the fixed initial
    point; ``u_pts`` (B, N+1, nu).  Returns (Ad, Ba, Bb, dd), each
    (B, N, ...), with x_{i+1} = Ad_i x_i + Ba_i u_i + Bb_i u_{i+1} + dd_i.
    """
    fv, Av, Bv = _linearize_continuous(f, x_pts, u_pts, data)
    nx = x_pts.shape[-1]
    I = torch.eye(nx, dtype=x_pts.dtype, device=x_pts.device)
    A_i, A_n = Av[:, :-1], Av[:, 1:]
    B_i, B_n = Bv[:, :-1], Bv[:, 1:]
    M = I - 0.5 * dt * A_n                       # (B, N, nx, nx)
    rhs_A = I + 0.5 * dt * A_i
    # the defect's residual at the linearisation point
    r = x_pts[:, :-1] - x_pts[:, 1:] + 0.5 * dt * (fv[:, :-1] + fv[:, 1:])

    Ad = solve_unrolled(M, rhs_A)
    Ba = solve_unrolled(M, 0.5 * dt * B_i)
    Bb = solve_unrolled(M, 0.5 * dt * B_n)
    dr = solve_unrolled(M, r[..., None])[..., 0]
    # absolute coordinates: x_{i+1} = x_lin_{i+1} + dx_{i+1}
    dd = (dr + x_pts[:, 1:]
          - torch.einsum("bnij,bnj->bni", Ad, x_pts[:, :-1])
          - torch.einsum("bnij,bnj->bni", Ba, u_pts[:, :-1])
          - torch.einsum("bnij,bnj->bni", Bb, u_pts[:, 1:]))
    return Ad, Ba, Bb, dd


def _collocation_weights(mpc: MPCParams, nx, N, dtype, device):
    """Trapezoid-rule cost weights over points 0..N: the tracking weights
    of points 1..N (N*nx,) (point 0 is fixed) and the control weights of
    points 0..N ((N+1)*nu,)."""
    q = np.zeros(nx)
    q[:3] = [mpc.q_s, mpc.q_n, mpc.q_mu]
    Qt = mpc.q_terminal_scale
    q_factor = np.concatenate([np.ones(N - 2), [(1.0 + Qt) / 2.0, Qt / 2.0]])
    r = np.array([mpc.r_a, mpc.r_delta_d])
    r_factor = np.concatenate([[0.5], np.ones(N - 1), [0.5]])
    return (_const(np.concatenate([q * w for w in q_factor]), dtype, device),
            _const(np.concatenate([r * w for w in r_factor]), dtype, device))


def _trapezoidal_stage_qp(x0, x_ref, q_diag, r_diag, r_soft, groups,
                          fr_group, Ad, Ba, Bb, dd, u_lb, u_ub):
    """The trapezoidal SQP subproblem as a batch of uncondensed
    :class:`ops.riccati.StageQP`s on the AUGMENTED state z_k = [x_k; u_k]
    (nz = nx + nu) over the N+1 points.

    The two-control coupling x_{k+1} = Ad_k x_k + Ba_k u_k + Bb_k u_{k+1}
    + dd_k becomes a one-step recurrence on z with stage control w_k =
    u_k:

        stage 0:    z_0 = [x0; u_0]          (A = 0, B = [0; I], d = [x0; 0])
        stage k>=1: z_k = [Ad Ba; 0 0] z_{k-1} + [Bb; I] w_k + [dd; 0]

    A row at point k touches (x_k, u_k), both inside z_k, so every row is
    a row on the stage's post-state (C = [C_x, D_u], D = 0).  Same
    minimiser as the condensed QP.

    ``groups``: x-only groups at points 1..N (their stage-0 block is
    absent: both sides inactive); ``fr_group``: an (x, u) group at points
    0..N, or None.  Returns (qp, const).
    """
    Bsz, N, nx, nu = Ba.shape
    N1 = N + 1
    dtype, dev = Ad.dtype, Ad.device
    nz = nx + nu
    n_soft = len(r_soft)
    zeros = lambda *shape: torch.zeros((Bsz,) + shape, dtype=dtype,
                                       device=dev)
    eye = torch.eye(nu, dtype=dtype, device=dev)

    # the augmented transition
    Atil = zeros(N1, nz, nz)
    Atil[:, 1:, :nx, :nx] = Ad
    Atil[:, 1:, :nx, nx:] = Ba
    Btil = zeros(N1, nz, nu)
    Btil[:, 1:, :nx] = Bb
    Btil[:, :, nx:] = eye
    dtil = zeros(N1, nz)
    dtil[:, 0, :nx] = x0
    dtil[:, 1:, :nx] = dd

    # costs: tracking on the x-part of z_1..z_N, control cost on w_k
    q_st = q_diag.reshape(N, nx)
    Qx = zeros(N1, nz)
    Qx[:, 1:, :nx] = 2.0 * q_st
    qx = zeros(N1, nz)
    qx[:, 1:, :nx] = -2.0 * q_st * x_ref
    Ru = (2.0 * r_diag.reshape(N1, nu)).repeat(Bsz, 1, 1)
    const = (q_st * x_ref * x_ref).reshape(Bsz, -1).sum(1)

    # rows: each group's sides as in ltv.build_stage_rows; the groups of
    # points 1..N get an inactive stage-0 block
    C_parts, Ws_parts, lo_parts, hi_parts = [], [], [], []

    def emit(Ct, off, lo, hi, slack_col, sign, lead_pad):
        rr = Ct.shape[-2]
        if lead_pad:
            Ct = torch.cat([zeros(1, rr, nz), Ct], 1)
            off = torch.cat([zeros(1, rr), off], 1)
        Ws = np.zeros((rr, n_soft))
        if slack_col is not None:
            Ws[np.arange(rr), slack_col] = sign
        lo_b = _const(lo, dtype, dev) - off
        hi_b = _const(hi, dtype, dev) - off
        if lead_pad:
            # the stage-0 block is structurally absent: no side active
            lo_b[:, 0] = -float("inf")
            hi_b[:, 0] = float("inf")
        C_parts.append(Ct)
        Ws_parts.append(_const(Ws, dtype, dev).expand(Bsz, N1, rr, n_soft))
        lo_parts.append(lo_b)
        hi_parts.append(hi_b)

    def group_rows(grp, lead_pad):
        rr = grp.C.shape[-2]
        Ct = torch.cat([grp.C, grp.D], -1)              # (B, Ng, r, nz)
        lb_g = np.broadcast_to(grp.lb, (rr,))
        ub_g = np.broadcast_to(grp.ub, (rr,))
        sidx = np.broadcast_to(grp.slack_idx, (rr,))
        hard = sidx < 0
        if np.all(hard):
            emit(Ct, grp.offset_const, lb_g, ub_g, None, 0.0, lead_pad)
            return
        if np.any(hard):
            raise ValueError("mix of hard/soft rows within a group")
        inf_v = np.full((rr,), np.inf)
        if np.all(np.isfinite(lb_g)):
            emit(Ct, grp.offset_const, lb_g, inf_v, sidx, +1.0, lead_pad)
        if np.all(np.isfinite(ub_g)):
            emit(Ct, grp.offset_const, -inf_v, ub_g, sidx, -1.0, lead_pad)

    for grp in groups:
        group_rows(grp, lead_pad=True)
    if fr_group is not None:
        group_rows(fr_group, lead_pad=False)

    C = torch.cat(C_parts, -2)
    s_zero = zeros(n_soft)
    qp = riccati.StageQP(
        Ad=Atil, Bd=Btil, dd=dtil, x0=zeros(nz), Qx=Qx, qx=qx, Ru=Ru,
        ru=zeros(N1, nu), g_s=_const(r_soft, dtype, dev).repeat(Bsz, 1),
        C=C, D=zeros(N1, C.shape[-2], nu), Ws=torch.cat(Ws_parts, -2),
        lbA=torch.cat(lo_parts, -1), ubA=torch.cat(hi_parts, -1),
        u_lb=u_lb, u_ub=u_ub, s_lb=s_zero,
        s_ub=torch.full_like(s_zero, float("inf")))
    return qp, const


def _roll_states(x0, Ad, Ba, Bb, dd, u):
    """The trapezoidal recurrence from x0 under ``u`` (B, N+1, nu):
    (B, N+1, nx), point 0 = x0."""
    xs = [x0]
    for i in range(Ad.shape[1]):
        xs.append(torch.einsum("bij,bj->bi", Ad[:, i], xs[-1])
                  + torch.einsum("bij,bj->bi", Ba[:, i], u[:, i])
                  + torch.einsum("bij,bj->bi", Bb[:, i], u[:, i + 1])
                  + dd[:, i])
    return torch.stack(xs, 1)


def _trapezoidal_nmpc(x0, x_ref, f, data, nx, groups_of, fr_group_of,
                      r_soft, u_lb, u_ub, mpc, x_init, u_init, opts,
                      sqp_iters, warm, backend, trust_u=None):
    """The trapezoidal SQP of both models on the ODE ``f(x, u, *data)``.
    ``groups_of(x_in, u_in)``: the
    x-only groups at points 1..N; ``fr_group_of(x_pts, u_pts)``: the
    group at points 0..N, or None."""
    _check_backend(backend)
    N = mpc.n_steps
    dtype, dev = x_init.dtype, x_init.device
    q_diag, r_diag = _collocation_weights(mpc, nx, N, dtype, dev)
    tr = None if trust_u is None else _const(trust_u, dtype, dev)

    def sqp_iter(carry, qp_warm):
        x_pts, u_pts = carry
        x_pts = torch.cat([x0[:, None], x_pts[:, 1:]], 1)
        Ad, Ba, Bb, dd = _trapezoidal_stages(f, x_pts, u_pts, mpc.dt,
                                             data)
        groups = groups_of(x_pts[:, 1:], u_pts[:, 1:])
        fr_group = fr_group_of(x_pts, u_pts)
        lb, ub = u_lb, u_ub
        if tr is not None:
            lb = torch.maximum(u_lb, u_pts - tr)
            ub = torch.minimum(u_ub, u_pts + tr)
        if backend == "riccati":
            qp_s, const = _trapezoidal_stage_qp(
                x0, x_ref, q_diag, r_diag, r_soft, groups, fr_group, Ad, Ba,
                Bb, dd, lb, ub)
            res = riccati.solve_stage_qp(qp_s, opts, warm=qp_warm)
            u_new = res.u
            return ((_roll_states(x0, Ad, Ba, Bb, dd, u_new), u_new),
                    (res.s, res.objective + const, res))
        A_bar, B_bar, d_bar = condense_general(
            Ad, dd, [(Ba, 0), (Bb, 1)], n_controls=N + 1)
        H, g, A, lbv, ubv, lbA, ubA, const = assemble_condensed_qp(
            A_bar, B_bar, d_bar, x0, x_ref, q_diag, r_diag, r_soft,
            groups + ([] if fr_group is None else [fr_group]), lb, ub)
        res = ipm.solve_qp(H, g, A, lbv, ubv, lbA, ubA, opts, warm=qp_warm)
        nc = (N + 1) * 2
        u_new = res.x[:, :nc].reshape(-1, N + 1, 2)
        return ((_roll_states(x0, Ad, Ba, Bb, dd, u_new), u_new),
                (res.x[:, nc:], res.objective + const, res))

    x_opt, u_opt, last = run_sqp(sqp_iter, x_init, u_init, sqp_iters, warm)
    return SqpResult(x_opt=x_opt, u_opt=u_opt, slack=last[0], fval=last[1],
                     qp=last[2])


def _track_groups(box_idx, x_in, u_in, mpc):
    """The hard [speed, steering angle] box and the soft track box."""
    return [
        cons.state_box_group(box_idx, np.array([0.0, -mpc.delta_max]),
                             np.array([np.inf, mpc.delta_max]),
                             np.array([-1, -1]), x_in, u_in),
        cons.state_box_group([1], np.array([-mpc.n_max]),
                             np.array([mpc.n_max]), np.array([0]),
                             x_in, u_in),
    ]


def trapezoidal_nmpc_kinematic(x0, x_ref, track, params: VehicleParams,
                               mpc: MPCParams, x_init, u_init,
                               opts: ipm.IpmOptions = ipm.IpmOptions(),
                               sqp_iters: int = 3, warm=None,
                               backend: str = "dense") -> SqpResult:
    """A batch of trapezoidal C-NMPC ticks, kinematic model.

    ``x0`` (B, 5); ``x_init`` (B, N+1, 5): the iterate over the
    collocation points (point 0 is pinned to x0); ``u_init`` (B, N+1, 2);
    ``x_ref`` (B, N, 5) for points 1..N.  The track and lateral-
    acceleration rows share one slack.  ``backend="riccati"``: the
    stage-wise subproblem on the augmented state (nz = 7, N+1 stages).
    """
    N = mpc.n_steps
    Bsz, dtype, dev = x0.shape[0], x_init.dtype, x_init.device
    u_lb = _const([-mpc.a_max, -mpc.delta_d_max], dtype,
                  dev).repeat(Bsz, N + 1, 1)
    groups_of = lambda x_in, u_in: _track_groups([3, 4], x_in, u_in, mpc) + [
        cons.kinematic_tyre_group(x_in, u_in, mpc, params, slack=0)]
    return _trapezoidal_nmpc(x0, x_ref, cm.f_curv_kin, (track, params), 5,
                             groups_of, lambda x, u: None, [mpc.w_track],
                             u_lb, -u_lb, mpc, x_init, u_init, opts,
                             sqp_iters, warm, backend)


def trapezoidal_nmpc_dynamic(x0, x_ref, track, params: VehicleParams,
                             mpc: MPCParams, x_init, u_init,
                             opts: ipm.IpmOptions = ipm.IpmOptions(),
                             sqp_iters: int = 3,
                             trust_u=(2.0, 0.15), warm=None,
                             backend: str = "dense") -> SqpResult:
    """A batch of trapezoidal C-NMPC ticks, dynamic model: the exact
    friction-ellipse row at every collocation point (point 0 through its
    control too), the track rows at points 1..N; slacks [track (w_track),
    tyre (w_slip)]; a trust region ``trust_u`` on the controls.  Shapes
    as :func:`trapezoidal_nmpc_kinematic` with nx = 7; Riccati: nz = 9.
    """
    N = mpc.n_steps
    Bsz, dtype, dev = x0.shape[0], x_init.dtype, x_init.device
    u_lb = _const([-np.inf, -mpc.delta_d_max], dtype,
                  dev).repeat(Bsz, N + 1, 1)
    u_ub = _const([np.inf, mpc.delta_d_max], dtype, dev).repeat(Bsz, N + 1,
                                                                 1)
    fr_rows = np.concatenate([[-1], np.arange(N)])     # points 0..N
    fr_cols = np.arange(N + 1)
    groups_of = lambda x_in, u_in: _track_groups([3, 6], x_in, u_in, mpc)
    fr_group_of = lambda x_pts, u_pts: cons.friction_ellipse_group(
        x_pts, u_pts, mpc, params, slack=1, state_rows=fr_rows,
        ctrl_cols=fr_cols)
    return _trapezoidal_nmpc(x0, x_ref, cm.f_curv_dyn_only, (track, params),
                             7, groups_of, fr_group_of,
                             [mpc.w_track, mpc.w_slip], u_lb, u_ub, mpc,
                             x_init, u_init, opts, sqp_iters, warm, backend,
                             trust_u=trust_u)


def _mv(a, v):
    """Stage-wise matrix-vector products: (B, N, i, j) x (B, N, j)."""
    return torch.einsum("bnij,bnj->bni", a, v)


@_highest_precision
def _hs_stages(f, x_knots, x_mids, u_pts, dt, data=()):
    """The linearised Hermite-Simpson interval maps in absolute
    coordinates.

    ``x_knots`` (B, N+1, nx): knots x_0..x_N; ``x_mids`` (B, N, nx):
    midpoints; ``u_pts`` (B, 2N+1, nu): controls at every point.  The
    midpoint-interpolation constraint (x_p + x_q)/2 + dt/8 (f_p - f_q) =
    x_m is solved for x_m and substituted into the Simpson defect x_p -
    x_q + dt/6 (f_p + 4 f_m + f_q) = 0, which gives the knot recurrence
    and the affine midpoint map.  Returns, each (B, N, ...),

      (Ad, B0, B1, B2, dd):      x_q = Ad x_p + B0 u_p + B1 u_m + B2 u_q + dd
      (P, Q, Bm0, Bm2, dm):      x_m = P x_p + Q x_q + Bm0 u_p + Bm2 u_q + dm
    """
    nx = x_knots.shape[-1]
    I = torch.eye(nx, dtype=x_knots.dtype, device=x_knots.device)
    u_kn = u_pts[:, 0::2]                       # (B, N+1, nu) at the knots
    u_md = u_pts[:, 1::2]                       # (B, N, nu) at the midpoints

    fk, Ak, Bk = _linearize_continuous(f, x_knots, u_kn, data)
    fm, Am, Bm = _linearize_continuous(f, x_mids, u_md, data)
    A_p, A_q = Ak[:, :-1], Ak[:, 1:]
    B_p, B_q = Bk[:, :-1], Bk[:, 1:]
    f_p, f_q = fk[:, :-1], fk[:, 1:]
    x_p, x_q = x_knots[:, :-1], x_knots[:, 1:]

    # the midpoint map in delta coordinates:
    # dx_m = P dx_p + Q dx_q + dt/8 (B_p du_p - B_q du_q) + r_m
    P = 0.5 * I + (dt / 8.0) * A_p
    Q = 0.5 * I - (dt / 8.0) * A_q
    r_m = (x_p + x_q) / 2.0 + (dt / 8.0) * (f_p - f_q) - x_mids

    # the Simpson defect linearised, dx_m substituted
    r_s = x_p - x_q + (dt / 6.0) * (f_p + 4.0 * fm + f_q)
    G_p = I + (dt / 6.0) * A_p + (2.0 * dt / 3.0) * (Am @ P)
    M_q = I - (dt / 6.0) * A_q - (2.0 * dt / 3.0) * (Am @ Q)
    C0 = (dt / 6.0) * B_p + (dt * dt / 12.0) * (Am @ B_p)
    C1 = (2.0 * dt / 3.0) * Bm
    C2 = (dt / 6.0) * B_q - (dt * dt / 12.0) * (Am @ B_q)
    r_tot = r_s + (2.0 * dt / 3.0) * _mv(Am, r_m)

    Ad = solve_unrolled(M_q, G_p)
    B0 = solve_unrolled(M_q, C0)
    B1 = solve_unrolled(M_q, C1)
    B2 = solve_unrolled(M_q, C2)
    dr = solve_unrolled(M_q, r_tot[..., None])[..., 0]
    # absolute offsets
    dd = (dr + x_q - _mv(Ad, x_p) - _mv(B0, u_kn[:, :-1]) - _mv(B1, u_md)
          - _mv(B2, u_kn[:, 1:]))
    Bm0 = (dt / 8.0) * B_p
    Bm2 = -(dt / 8.0) * B_q
    dm = (r_m + x_mids - _mv(P, x_p) - _mv(Q, x_q) - _mv(Bm0, u_kn[:, :-1])
          - _mv(Bm2, u_kn[:, 1:]))
    return (Ad, B0, B1, B2, dd), (P, Q, Bm0, Bm2, dm)


def _hs_weights(mpc: MPCParams, nx, N, dtype, device):
    """Simpson cost weights over points 0..2N: the tracking weights of
    points 1..2N (2N*nx,) (point 0 is fixed) and the control weights of
    every point ((2N+1)*nu,); the factors are host constants, as in the
    JAX package."""
    NC = 2 * N + 1
    Qt = mpc.q_terminal_scale
    qf = np.empty(NC)
    qf[0] = 1.0 / 6.0
    qf[1::2] = 4.0 / 6.0                        # midpoints
    qf[2::2] = 2.0 / 6.0                        # interior knots
    qf[2 * N - 2] = (1.0 + Qt) / 6.0
    qf[2 * N - 1] = 4.0 * Qt / 6.0
    qf[2 * N] = Qt / 6.0
    rf = np.empty(NC)
    rf[1::2] = 4.0 / 6.0
    rf[0::2] = 2.0 / 6.0
    rf[0] = rf[-1] = 1.0 / 6.0
    q = np.zeros(nx)
    q[:3] = [mpc.q_s, mpc.q_n, mpc.q_mu]
    r = np.array([mpc.r_a, mpc.r_delta_d])
    return (_const(np.concatenate([q * w for w in qf[1:]]), dtype, device),
            _const(np.concatenate([r * w for w in rf]), dtype, device))


def _interleave(mid, knot):
    """(B, N, ...) midpoint and knot tensors as the virtual stages 1..2N,
    [mid_0, knot_1, mid_1, knot_2, ...]: (B, 2N, ...)."""
    return torch.stack([mid, knot], 2).flatten(1, 2)


def hs_nmpc_kinematic(x0, x_ref, track, params: VehicleParams,
                      mpc: MPCParams, x_init, u_init,
                      opts: ipm.IpmOptions = ipm.IpmOptions(),
                      sqp_iters: int = 3, warm=None) -> SqpResult:
    """A batch of Hermite-Simpson C-NMPC ticks, kinematic model, dense
    backend: 2N+1 collocation points with the midpoints eliminated, the
    Simpson cost weights, the soft track and lateral-acceleration rows at
    every point after the first sharing one slack.

    ``x0`` (B, 5); ``x_init`` (B, 2N+1, 5): the iterate over all points
    (point 0 is pinned to x0); ``u_init`` (B, 2N+1, 2); ``x_ref``
    (B, N, 5) at the knots (midpoint references interpolated).  The
    condensed QP has (2N+1)*2 + 1 variables.
    """
    N = mpc.n_steps
    Bsz, dtype, dev = x0.shape[0], x_init.dtype, x_init.device
    nx, nu = 5, 2
    NC = 2 * N + 1
    NCnu = NC * nu
    data = (track, params)
    q_diag, r_diag = _hs_weights(mpc, nx, N, dtype, dev)

    # references at points 1..2N: each midpoint's between its knots
    x_ref_k = torch.cat([x0[:, None], x_ref], 1)          # (B, N+1, nx)
    x_ref_all = _interleave(0.5 * (x_ref_k[:, :-1] + x_ref_k[:, 1:]), x_ref)
    u_lb = _const([-mpc.a_max, -mpc.delta_d_max], dtype,
                  dev).repeat(Bsz, NC, 1)
    eye = torch.eye(nx, dtype=dtype, device=dev).expand(Bsz, 1, nx, nx)

    def sqp_iter(carry, qp_warm):
        x_pts, u_pts = carry
        x_pts = torch.cat([x0[:, None], x_pts[:, 1:]], 1)
        (Ad, B0, B1, B2, dd), (Pm, Qm, Bm0, Bm2, dm) = _hs_stages(
            cm.f_curv_kin, x_pts[:, 0::2], x_pts[:, 1::2], u_pts, mpc.dt,
            data)

        # the knot chain condensed with its (u_2i, u_2i+1, u_2i+2) coupling
        A_bar, B_bar, d_bar = condense_general(
            Ad, dd, [(B0, 0), (B1, 1), (B2, 2)], n_controls=NC,
            ctrl_stride=2)
        # the knot maps from knot 0 (= x0 exactly: A = I, B = 0, d = 0)
        knotA = torch.cat([eye, A_bar], 1)
        knotB = torch.cat([torch.zeros_like(B_bar[:, :1]), B_bar], 1)
        knotd = torch.cat([torch.zeros_like(d_bar[:, :1]), d_bar], 1)

        # the midpoint maps composed from their two knots:
        # x_m(i) = Pm_i x_knot(i) + Qm_i x_knot(i+1) + Bm0_i u_2i
        #          + Bm2_i u_2i+2 + dm_i
        A_mid = Pm @ knotA[:, :-1] + Qm @ knotA[:, 1:]
        B_mid = (Pm @ knotB[:, :-1] + Qm @ knotB[:, 1:]).contiguous()
        d_mid = dm + _mv(Pm, knotd[:, :-1]) + _mv(Qm, knotd[:, 1:])
        column_blocks(B_mid, nu, 2 * nu).add_(Bm0)           # u_2i
        column_blocks(B_mid, nu, 2 * nu, 2 * nu).add_(Bm2)   # u_2i+2

        A_all = _interleave(A_mid, knotA[:, 1:])
        B_all = _interleave(B_mid, knotB[:, 1:])
        d_all = _interleave(d_mid, knotd[:, 1:])
        groups = _track_groups([3, 4], x_pts[:, 1:], u_pts[:, 1:], mpc) + [
            cons.kinematic_tyre_group(x_pts[:, 1:], u_pts[:, 1:], mpc,
                                      params, slack=0)]
        H, g, A, lb, ub, lbA, ubA, const = assemble_condensed_qp(
            A_all, B_all, d_all, x0, x_ref_all, q_diag, r_diag,
            [mpc.w_track], groups, u_lb, -u_lb)
        res = ipm.solve_qp(H, g, A, lb, ub, lbA, ubA, opts, warm=qp_warm)
        u_flat = res.x[:, :NCnu]
        x_new = (torch.einsum("bnij,bj->bni", A_all, x0)
                 + torch.einsum("bnij,bj->bni", B_all, u_flat) + d_all)
        return ((torch.cat([x0[:, None], x_new], 1),
                 u_flat.reshape(Bsz, NC, nu)),
                (res.x[:, NCnu:], res.objective + const, res))

    x_opt, u_opt, last = run_sqp(sqp_iter, x_init, u_init, sqp_iters, warm)
    return SqpResult(x_opt=x_opt, u_opt=u_opt, slack=last[0], fval=last[1],
                     qp=last[2])


def hs_shift_trajectory(x_opt, u_opt, step_half_fn, data=()):
    """The warm-start shift of a batch on the Hermite-Simpson grid: a
    tick advances one knot, two points, so the first two points go and
    the tail grows by two half-steps of ``step_half_fn`` (per instance:
    ``x`` (nx,), ``u`` (nu,), then ``*data``) under the last control."""
    step = lambda x, u: vmap_instances(step_half_fn, (x, u), 1, data)
    x_a = step(x_opt[:, -1], u_opt[:, -1])
    x_b = step(x_a, u_opt[:, -1])
    return (torch.cat([x_opt[:, 2:], x_a[:, None], x_b[:, None]], 1),
            torch.cat([u_opt[:, 2:], u_opt[:, -1:], u_opt[:, -1:]], 1))
