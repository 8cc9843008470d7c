"""Offline minimum-time raceline planners, s-domain and periodic (port of
``fsae_mpc_tpu.planner.min_time``).

Both planners are SQP loops with partial condensing:

* The lap is split into K segments of M nodes.  Within a segment the
  linearised defect chain is condensed, so the interior states are
  affine in (the segment's boundary state, its controls); the boundary
  states stay decision variables, tied by K periodicity equality rows
  end(segment k) = boundary(k+1 mod K).  The dynamic planner takes M = 1
  (full multiple shooting): its Pacejka slip modes relax within a node.
* The lap-time objective sum_i ds / s_dot(y_i, s_i) is expanded to second
  order per node (``torch.func`` gradient and Hessian, Gershgorin-shifted
  to positive semi-definite).
* Each subproblem is one dense QP for ``ops.ipm.solve_qp``; its step is
  tried at seven step lengths at once (a batch), each trial rolled out
  through the NONLINEAR step map inside the segments, and the best one on
  the exact merit (cost + rho |defect|_1 + the soft rows' penalty) is
  taken if it improves on the incumbent, else the step is rejected and
  the trust region on the controls and boundary states shrinks.

The loop runs exactly ``iters`` steps, as the JAX package's ``lax.scan``
does (no early exit).  Precision and device: the planners run in the
track's dtype, float64 as in the JAX package, whose subproblems need the
adaptive f64 ``IpmOptions`` (tol 5e-14): the time change 1/s_dot mixes
scales of ~1e-3..1e3 across a lap.  Their KKT matrices (n ~ 4,000 for
the dynamic planner at 500 nodes) are f64 and far wider than the dense
Cholesky kernels take, so on the card the caller passes
``IpmOptions(chol="lapack")``; under ``chol="auto"`` the solver's entry
check refuses them before any launch, and the planner does not switch
route on its own.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.func import grad, hessian, jacfwd, vmap

from ..config import VehicleParams
from ..models import curvilinear as cm
from ..mpc.ltv import _const
from ..ops import ipm
from ..ops.linalg import column_blocks

ALPHAS = (1.0, 0.6, 0.35, 0.2, 0.1, 0.04, 0.015)   # the line search's steps


@dataclasses.dataclass(frozen=True)
class PlannerResult:
    y_opt: torch.Tensor        # (N, ny) node states
    u_opt: torch.Tensor        # (N, nu) node controls
    t_node: torch.Tensor       # (N,) per-node traversal times ds / s_dot
    lap_time: torch.Tensor     # () the sum of t_node
    slack: torch.Tensor        # (n_soft,) (the dynamic planner's)
    merit: torch.Tensor        # () the last merit value
    defect_norm: torch.Tensor  # () the last max |nonlinear defect|


def _segment_condense(Ad, Bd, dd, K, M):
    """Condense each segment's chain.  ``Ad`` (N, ny, ny), ``Bd``
    (N, ny, nu), ``dd`` (N, ny) with N = K*M.  Returns, for segment k and
    step j, the map of the post-step state y_{kM+j+1} = A[k,j] xb_k +
    B[k,j] u_seg_k + d[k,j]: A (K, M, ny, ny), B (K, M, ny, M*nu),
    d (K, M, ny)."""
    ny, nu = Ad.shape[-1], Bd.shape[-1]
    Ad = Ad.reshape(K, M, ny, ny)
    Bd = Bd.reshape(K, M, ny, nu)
    dd = dd.reshape(K, M, ny)
    phi = torch.eye(ny, dtype=Ad.dtype, device=Ad.device).expand(K, ny, ny)
    G = torch.zeros((K, ny, M * nu), dtype=Ad.dtype, device=Ad.device)
    delta = torch.zeros((K, ny), dtype=Ad.dtype, device=Ad.device)
    A_s, B_s, d_s = [], [], []
    for j in range(M):
        A_j = Ad[:, j]
        phi = A_j @ phi
        G = A_j @ G                 # a new tensor: the stored G_{j-1} stays
        G[:, :, j * nu:(j + 1) * nu] = Bd[:, j]
        delta = torch.einsum("kij,kj->ki", A_j, delta) + dd[:, j]
        A_s.append(phi)
        B_s.append(G)
        d_s.append(delta)
    return torch.stack(A_s, 1), torch.stack(B_s, 1), torch.stack(d_s, 1)


def _node_maps(A_seg, B_seg, d_seg, K, M, ny, nu, nv, nu_total):
    """The affine maps y_i = P_i v + q_i of all N nodes over the decision
    vector v = [u (N*nu), xb (K*ny), slacks]: node kM is the boundary
    variable itself, node kM+j (j >= 1) row j-1 of its segment's map.
    Returns P (N, ny, nv), q (N, ny)."""
    dtype, dev = A_seg.dtype, A_seg.device
    eye = torch.eye(ny, dtype=dtype, device=dev).expand(K, 1, ny, ny)
    rows_x = torch.cat([eye, A_seg[:, :M - 1]], 1)        # (K, M, ny, ny)
    rows_u = torch.cat([torch.zeros_like(B_seg[:, :1]), B_seg[:, :M - 1]],
                       1)                                 # (K, M, ny, M*nu)
    q = torch.cat([torch.zeros_like(d_seg[:, :1]), d_seg[:, :M - 1]], 1)
    P = torch.zeros((K, M * ny, nv), dtype=dtype, device=dev)
    column_blocks(P, ny, ny, nu_total).copy_(rows_x.reshape(K, M * ny, ny))
    column_blocks(P, M * nu, M * nu).copy_(
        rows_u.reshape(K, M * ny, M * nu))
    return P.reshape(K * M, ny, nv), q.reshape(K * M, ny)


def _psd_shift(Hs):
    """Shift each (ny, ny) Hessian by its Gershgorin lower bound, to
    positive semi-definite (+1e-8)."""
    diag = torch.diagonal(Hs, dim1=-2, dim2=-1)
    radius = Hs.abs().sum(-1) - diag.abs()
    lam_min = (diag - radius).amin(-1)
    shift = torch.clamp_min(-lam_min, 0.0) + 1e-8
    return Hs + shift[..., None, None] * torch.eye(
        Hs.shape[-1], dtype=Hs.dtype, device=Hs.device)


def _plan_sqp(defect_fn, time_of, s_nodes, y0, u0, q_reg, r_reg, row_groups,
              u_lb, u_ub, n_soft, soft_w, opts, iters, seg_len: int,
              rho=1e3, x_scale=None, tr0=1.0, tr_min=0.02, tr_max=4.0):
    """The planners' periodic SQP loop with partial condensing.

    ``defect_fn(s, y, u) -> y_next``: the step map from the node at
    arclength s (the lap wraps through the equality rows);
    ``time_of(y, s)``: the node's traversal time; ``row_groups``: a list
    of ``(sel_fn(y, u) -> values, lb, ub, slack_idx)``.

    Globalisation (the reference's IPOPT filter and line search): the
    exact l1 merit cost + rho |defect|_1 + sum_s w_s (soft-row
    violation)_+, a monotone line search over :data:`ALPHAS` that may
    reject the step, and a trust region (a box on the controls and the
    boundary states, radius ``tr``) that shrinks by 4 on a rejection and
    grows by 1.5 on an accepted step of length 1 or 0.6.  Returns (y, u,
    t_node, slack, merit, defect_norm).
    """
    N, ny = y0.shape
    nu = u0.shape[1]
    dtype, dev = y0.dtype, y0.device
    M = seg_len
    if N % M:
        raise ValueError("the segment length must divide the node count")
    K = N // M
    if K < 2:
        raise ValueError("the periodic closure needs at least two segments")
    nu_total = N * nu
    nv = nu_total + K * ny + n_soft
    tensor = lambda a: _const(a, dtype, dev)
    x_scale = (torch.ones((ny,), dtype=dtype, device=dev) if x_scale is None
               else x_scale.to(dtype))
    u_scale = (u_ub - u_lb) / 2.0
    s_seg = s_nodes.reshape(K, M)

    # torch.func's forward mode promotes a 0-d tensor times a Python float
    # to float64: every derivative comes back in the plan's dtype
    t_val = vmap(time_of)
    t_grad = lambda y, s: vmap(grad(time_of))(y, s).to(dtype)
    t_hess = lambda y, s: vmap(hessian(time_of))(y, s).to(dtype)
    step = vmap(defect_fn)

    # the soft rows' penalty weights, resolved once
    soft_meta = []
    for sel_fn, lo, hi, sidx in row_groups:
        si = np.atleast_1d(np.asarray(sidx))
        if np.all(si < 0):
            continue
        w = [soft_w[i] if i >= 0 else 0.0 for i in si]
        soft_meta.append((vmap(sel_fn), tensor(np.atleast_1d(lo)),
                          tensor(np.atleast_1d(hi)), tensor(w)))

    def defect_jacobians(y, u):
        def one(s, y_i, u_i):
            g = lambda yy, uu: defect_fn(s, yy, uu)
            Ad = jacfwd(g, argnums=0)(y_i, u_i).to(dtype)
            Bd = jacfwd(g, argnums=1)(y_i, u_i).to(dtype)
            return Ad, Bd, g(y_i, u_i) - Ad @ y_i - Bd @ u_i
        return vmap(one)(s_nodes, y, u)

    def merit(y, u):
        cost = ((q_reg * y * y).sum() + (r_reg * u * u).sum()
                + t_val(y, s_nodes).sum())
        # the exact l1 penalty of the soft rows: the QP's slack objective
        # at its solution, and defined at any trial point
        for sel, lo, hi, w in soft_meta:
            v = sel(y, u).reshape(N, -1)
            cost = cost + (w * (torch.clamp_min(lo - v, 0.0)
                                + torch.clamp_min(v - hi, 0.0))).sum()
        gap = step(s_nodes, y, u) - torch.roll(y, -1, 0)
        return cost + rho * gap.abs().sum(), gap.abs().amax()

    def rollout(xb, u):
        """The nonlinear states of every node from the boundary states
        ``xb`` (A, K, ny) under ``u`` (A, N, nu), for A trials at once:
        (A, N, ny)."""
        A_ = xb.shape[0]
        u_seg = u.reshape(A_, K, M, nu)
        s_flat = s_seg.expand(A_, K, M)
        ys, y_j = [], xb
        for j in range(M):
            ys.append(y_j)
            y_j = step(s_flat[:, :, j].reshape(-1), y_j.reshape(-1, ny),
                       u_seg[:, :, j].reshape(-1, nu)).reshape(A_, K, ny)
        return torch.stack(ys, 2).reshape(A_, N, ny)

    alphas = tensor(ALPHAS)
    eye_ny = torch.eye(ny, dtype=dtype, device=dev)

    def sqp_iter(y, u, tr):
        Ad, Bd, dd = defect_jacobians(y, u)
        A_seg, B_seg, d_seg = _segment_condense(Ad, Bd, dd, K, M)
        P, q = _node_maps(A_seg, B_seg, d_seg, K, M, ny, nu, nv, nu_total)

        # ---- the objective's model ----------------------------------------
        gt = t_grad(y, s_nodes)
        Ht = _psd_shift(t_hess(y, s_nodes))
        Wq = 2.0 * torch.diag_embed(q_reg) + Ht
        gy = 2.0 * q_reg * y + gt
        WP = torch.einsum("nrs,nsj->nrj", Wq, P)
        H = P.reshape(N * ny, nv).mT @ WP.reshape(N * ny, nv)
        H[:nu_total, :nu_total] += torch.diag(2.0 * r_reg.reshape(-1))
        gvec = torch.einsum("nri,nr->i", P, gy + torch.einsum(
            "nrs,ns->nr", Wq, q - y))
        if n_soft:
            gvec[nu_total + K * ny:] = tensor(soft_w)

        # the trust region: controls within the hard bounds and +-tr*scale
        # of the incumbent, boundary states within +-tr*scale of theirs
        xb_now = y[::M]
        zeros_s = torch.zeros((n_soft,), dtype=dtype, device=dev)
        lb_v = torch.cat([torch.maximum(u_lb, u - tr * u_scale).reshape(-1),
                          (xb_now - tr * x_scale).reshape(-1), zeros_s])
        ub_v = torch.cat([torch.minimum(u_ub, u + tr * u_scale).reshape(-1),
                          (xb_now + tr * x_scale).reshape(-1),
                          torch.full_like(zeros_s, float("inf"))])

        # ---- periodicity: the end of segment k == boundary k+1 (mod K) ---
        eqA = torch.zeros((K, ny, nv), dtype=dtype, device=dev)
        column_blocks(eqA, ny, ny, nu_total).copy_(A_seg[:, M - 1])
        column_blocks(eqA, M * nu, M * nu).copy_(B_seg[:, M - 1])
        column_blocks(eqA[:-1], ny, ny, nu_total + ny).copy_(
            -eye_ny.expand(K - 1, ny, ny))
        eqA[-1, :, nu_total:nu_total + ny] = -eye_ny
        eqOff = d_seg[:, M - 1].reshape(K * ny)
        A_rows, lbs, ubs = [eqA.reshape(K * ny, nv)], [-eqOff], [-eqOff]

        # ---- the node rows -------------------------------------------------
        for sel_fn, lo, hi, sidx in row_groups:
            def one(y_i, u_i, sel_fn=sel_fn):
                v = sel_fn(y_i, u_i).reshape(-1)
                Jy = jacfwd(sel_fn, argnums=0)(y_i, u_i).reshape(-1, ny)
                Ju = jacfwd(sel_fn, argnums=1)(y_i, u_i).reshape(-1, nu)
                return v, Jy.to(dtype), Ju.to(dtype)
            v0, Jy, Ju = vmap(one)(y, u)
            r = v0.shape[1]
            rows = torch.einsum("nri,nij->nrj", Jy, P).contiguous()
            column_blocks(rows, nu, nu).add_(Ju)
            off = (v0 + torch.einsum("nri,ni->nr", Jy, q - y)
                   - torch.einsum("nri,ni->nr", Ju, u)).reshape(N * r)
            rows = rows.reshape(N * r, nv)
            lo_b = np.broadcast_to(np.asarray(lo, np.float64),
                                   (N, r)).reshape(-1)
            hi_b = np.broadcast_to(np.asarray(hi, np.float64),
                                   (N, r)).reshape(-1)
            si = np.broadcast_to(np.asarray(sidx), (N, r)).reshape(-1)
            if np.all(si < 0):
                A_rows.append(rows)
                lbs.append(tensor(lo_b) - off)
                ubs.append(tensor(hi_b) - off)
                continue
            onehot = np.zeros((N * r, n_soft))
            onehot[np.arange(N * r), si] = 1.0
            onehot = tensor(onehot)
            inf_v = torch.full((N * r,), float("inf"), dtype=dtype,
                               device=dev)
            if np.all(np.isfinite(lo_b)):
                rws = rows.clone()
                rws[:, nu_total + K * ny:] += onehot
                A_rows.append(rws)
                lbs.append(tensor(lo_b) - off)
                ubs.append(inf_v)
            if np.all(np.isfinite(hi_b)):
                rws = rows.clone()
                rws[:, nu_total + K * ny:] -= onehot
                A_rows.append(rws)
                lbs.append(-inf_v)
                ubs.append(tensor(hi_b) - off)
        A = torch.cat(A_rows, 0)

        v0_init = torch.cat([u.reshape(-1), xb_now.reshape(-1), zeros_s])
        res = ipm.solve_qp(H[None], gvec[None], A[None], lb_v[None],
                           ub_v[None], torch.cat(lbs)[None],
                           torch.cat(ubs)[None], opts, x0=v0_init[None])
        x = res.x[0]
        slack = x[nu_total + K * ny:]
        dv = x - v0_init

        # the trials, rolled out through the NONLINEAR step map inside the
        # segments: the interior defects are exactly zero at every trial,
        # only the K boundary defects remain for the Newton iteration
        v_a = v0_init + alphas[:, None] * dv
        u_a = v_a[:, :nu_total].reshape(-1, N, nu)
        y_a = rollout(v_a[:, nu_total:nu_total + K * ny].reshape(-1, K, ny),
                      u_a)
        ms, dmaxs = vmap(merit)(y_a, u_a)
        m_cur, d_cur = merit(y, u)
        k = torch.argmin(ms)
        accepted = ms[k] < m_cur
        y_new = torch.where(accepted, y_a[k], y)
        u_new = torch.where(accepted, u_a[k], u)
        m_new = torch.where(accepted, ms[k], m_cur)
        d_new = torch.where(accepted, dmaxs[k], d_cur)
        tr_new = torch.where(~accepted, tr * 0.25, torch.where(
            k <= 1, torch.clamp_max(tr * 1.5, tr_max), tr))
        return (y_new, u_new, torch.clamp_min(tr_new, tr_min), slack, m_new,
                d_new)

    y, u, tr = y0, u0, tensor(tr0)
    slack = merit_v = dnorm = None
    for _ in range(iters):
        y, u, tr, slack, merit_v, dnorm = sqp_iter(y, u, tr)
    if not n_soft:
        slack = torch.zeros((0,), dtype=dtype, device=dev)
    return y, u, t_val(y, s_nodes), slack, merit_v, dnorm


def _result(y, u, t_node, slack, merit, dnorm) -> PlannerResult:
    return PlannerResult(y_opt=y, u_opt=u, t_node=t_node,
                         lap_time=t_node.sum(), slack=slack, merit=merit,
                         defect_norm=dnorm)


def minimum_time_planner_kinematic(track,
                                   params: VehicleParams = VehicleParams(),
                                   n_nodes: int = 1000,
                                   opts: ipm.IpmOptions = ipm.IpmOptions(),
                                   iters: int = 30,
                                   seg_len: int = 4) -> PlannerResult:
    """Kinematic minimum-time raceline on the track's device and dtype.

    Node state [n, mu, v, delta], controls [a, delta_d]; Euler defects in
    s with the periodic wrap; cost 0.01 n^2 + 0.01 mu^2 + 1e-6 a^2 +
    0.01 delta_d^2 + ds/s_dot per node; bounds |n| <= 1, v in [0, 50],
    |delta| <= 0.4, |a| <= 10, |delta_d| <= 0.4.
    """
    dtype, dev = track.px.dtype, track.px.device
    N = n_nodes
    ds = track.L / N
    s_nodes = ds * torch.arange(N, dtype=dtype, device=dev)

    def s_dot(y, s):
        n, mu, v, delta = y
        beta = torch.arctan(params.lr_ratio * torch.tan(delta))
        return v * torch.cos(mu + beta) / (1.0 - n * track.curvature(s))

    def time_of(y, s):
        # the line search may probe states with s_dot <= 0: the time
        # model stays finite (the merit's defect term rejects them)
        return ds / torch.clamp_min(s_dot(y, s), 0.3)

    def step_map(s, y, u):
        n, mu, v, delta = y
        beta = torch.arctan(params.lr_ratio * torch.tan(delta))
        k = track.curvature(s)
        sd = v * torch.cos(mu + beta) / (1.0 - n * k)
        sd = torch.where(sd.abs() < 0.3, torch.full_like(sd, 0.3), sd)
        y_d = torch.stack([v * torch.sin(mu + beta),
                           v * torch.sin(beta) / params.lr - sd * k,
                           u[0], u[1]]) / sd
        return y + ds * y_d

    tensor = lambda a: _const(a, dtype, dev)
    y0 = torch.zeros((N, 4), dtype=dtype, device=dev)
    y0[:, 2] = 20.0
    u0 = torch.zeros((N, 2), dtype=dtype, device=dev)
    row_groups = [
        (lambda y, u: torch.stack([y[0], y[2], y[3]]),
         np.array([-1.0, 0.0, -0.4]), np.array([1.0, 50.0, 0.4]),
         np.array([-1, -1, -1])),
    ]
    return _result(*_plan_sqp(
        step_map, time_of, s_nodes, y0, u0,
        tensor([0.01, 0.01, 0.0, 0.0]).repeat(N, 1),
        tensor([1e-6, 0.01]).repeat(N, 1), row_groups, tensor([-10.0, -0.4]),
        tensor([10.0, 0.4]), 0, [], opts, iters, seg_len,
        x_scale=tensor([0.5, 0.3, 5.0, 0.2])))


def minimum_time_planner_dynamic(track,
                                 params: VehicleParams = VehicleParams(),
                                 n_nodes: int = 500,
                                 opts: ipm.IpmOptions = ipm.IpmOptions(),
                                 iters: int = 40,
                                 seg_len: int = 1,
                                 friction_util: float = 1.0
                                 ) -> PlannerResult:
    """Dynamic minimum-time raceline on the track's device and dtype.

    Node state [n, mu, x_d, y_d, theta_d, delta] (s removed), controls
    [a, delta_d]; Heun (trapezoidal predictor) s-domain defects with the
    periodic wrap; the friction-ellipse utilisation <= ``friction_util``
    softened at w = 1e5 and the track |n| <= 0.5 at w = 1e8; slacks
    [track, tyre].  ``friction_util`` defaults to 1.0, the JAX package's
    default (the MATLAB reference's planner uses 0.75).
    """
    dtype, dev = track.px.dtype, track.px.device
    N = n_nodes
    ds = track.L / N
    s_nodes = ds * torch.arange(N, dtype=dtype, device=dev)
    u_dummy = torch.zeros((2,), dtype=dtype, device=dev)

    def full_state(y, s):
        return torch.cat([s.reshape(1), y])

    def y_prime(y, u, s):
        f, _ = cm.f_curv_dyn(full_state(y, s), u, track, params)
        sd = torch.where(f[0].abs() < 0.3, torch.full_like(f[0], 0.3), f[0])
        return f[1:] / sd

    def time_of(y, s):
        f, _ = cm.f_curv_dyn(full_state(y, s), u_dummy, track, params)
        return ds / torch.clamp_min(f[0], 0.3)

    def step_map(s, y, u):
        k1 = y_prime(y, u, s)
        k2 = y_prime(y + ds * k1, u, s + ds)
        return y + 0.5 * ds * (k1 + k2)

    # the cold start: each node at the kinematic steady state of its
    # curvature (theta_d = v k, delta = atan(L k), y_d = v tan(beta)) at
    # the friction-limited cornering speed, smoothed backward and forward
    # by the longitudinal-acceleration limit and capped at 18 m/s
    k_nodes = track.curvature(s_nodes)
    v_corner = torch.clamp_max(torch.sqrt(
        params.ac_max / torch.clamp_min(k_nodes.abs(), 1e-4)), 18.0)

    def smooth(v):
        # two periodic passes of v_i <= sqrt(v_{i-1}^2 + 2 a ds)
        for _ in range(2):
            prev, out = v[-1], []
            for i in range(N):
                prev = torch.minimum(v[i], torch.sqrt(prev * prev
                                                      + 2.0 * 8.0 * ds))
                out.append(prev)
            v = torch.stack(out)
        return v

    v_nodes = smooth(smooth(v_corner).flip(0)).flip(0)
    delta_init = torch.arctan((params.lf + params.lr) * k_nodes)
    beta_init = torch.arctan(params.lr_ratio * torch.tan(delta_init))
    zero = torch.zeros_like(v_nodes)
    y0 = torch.stack([zero, zero, v_nodes, v_nodes * torch.tan(beta_init),
                      v_nodes * k_nodes, delta_init], 1)
    # controls: a = v dv/ds (the chain rule), delta_d = delta'(s) s_dot
    a_init = torch.clamp(
        v_nodes * (torch.roll(v_nodes, -1) - v_nodes) / ds, -10.0, 10.0)
    ddel = (torch.roll(delta_init, -1) - delta_init) / ds * v_nodes
    u0 = torch.stack([a_init, ddel], 1)

    def friction(y, u):
        fcr = cm.rear_lateral_force(torch.cat([torch.zeros_like(y[:1]), y]),
                                    params)
        return ((fcr / (params.m * params.ac_max)) ** 2
                + (u[0] / params.al_max) ** 2)

    row_groups = [
        (lambda y, u: torch.stack([y[2], y[5]]),
         np.array([0.0, -0.4]), np.array([np.inf, 0.4]), np.array([-1, -1])),
        (lambda y, u: y[:1], np.array([-0.5]), np.array([0.5]),
         np.array([0])),
        (friction, np.array([-np.inf]), np.array([float(friction_util)]),
         np.array([1])),
    ]
    tensor = lambda a: _const(a, dtype, dev)
    return _result(*_plan_sqp(
        step_map, time_of, s_nodes, y0, u0,
        tensor([0.01, 0.01, 0.0, 0.0, 0.0, 0.0]).repeat(N, 1),
        tensor([1e-6, 0.01]).repeat(N, 1), row_groups, tensor([-10.0, -0.4]),
        tensor([10.0, 0.4]), 2, [1e8, 1e5], opts, iters, seg_len,
        x_scale=tensor([0.5, 0.3, 5.0, 1.0, 0.5, 0.2])))
