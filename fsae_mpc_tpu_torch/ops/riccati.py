"""Stage-wise block-Riccati primal-dual interior-point QP solver (port of
``fsae_mpc_tpu.ops.riccati``).

    variables   u_k (nu), x_{k+1} (nx) for k = 0..N-1, global slacks sigma
    dynamics    x_{k+1} = Ad_k x_k + Bd_k u_k + dd_k          (equalities)
    rows        lbA_k <= C_k x_{k+1} + D_k u_k + Ws_k sigma <= ubA_k
    bounds      u_lb <= u <= u_ub,  s_lb <= sigma <= s_ub

The JAX solver is written per instance and ``vmap``ped, with its Pallas
kernels swapped in through ``custom_vmap``.  Here the batch is written
out: every tensor has a leading batch dimension B, every reduction of the
JAX code (``max``/``min``/``sum``/``all``) is taken over the non-batch
dimensions of one instance, and every selection (freeze, finite-iterate
rejection, best iterate, restart gate) is made per instance -- one
instance's escalation or freeze never touches another's result.

The Riccati sweeps go through ``ops/kernels/riccati.py``: on a CUDA tensor
the hand-written kernels, on a CPU tensor their plain PyTorch versions
(which hold the tiny SPD helpers ``_spd_inv_small``, ``_chol_small`` and
``_cho_solve_small`` of the JAX module).
With ``opts.adaptive=False`` (the f32 presets) a solve is a fixed sequence
of device work with no host synchronisation.
"""

from __future__ import annotations

import dataclasses

import torch

from .condense import rollout
from .ipm import (D_CAP_F32, D_CAP_F64, IpmOptions, _all_finite, _amax,
                  _amin, _bc, _bsum, _leaves, _pow2, _side, _where)
from .kernels import riccati as kriccati
from .kernels.riccati import _cho_solve_small, _chol_small
from .precision import fma_add, residual_affine
from .precision import highest as _highest_precision


# ---------------------------------------------------------------------------
# problem / result containers (batch-first)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StageQP:
    """A batch of stage-wise QPs.

    Objective  sum_k [ 0.5 x_{k+1}' diag(Qx_k) x_{k+1} + qx_k' x_{k+1}
                       + 0.5 u_k' diag(Ru_k) u_k + ru_k' u_k ] + g_s' sigma
    """

    Ad: torch.Tensor       # (B, N, nx, nx)
    Bd: torch.Tensor       # (B, N, nx, nu)
    dd: torch.Tensor       # (B, N, nx)
    x0: torch.Tensor       # (B, nx)
    Qx: torch.Tensor       # (B, N, nx)
    qx: torch.Tensor       # (B, N, nx)
    Ru: torch.Tensor       # (B, N, nu)
    ru: torch.Tensor       # (B, N, nu)
    g_s: torch.Tensor      # (B, ns)
    C: torch.Tensor        # (B, N, r, nx)
    D: torch.Tensor        # (B, N, r, nu)
    Ws: torch.Tensor       # (B, N, r, ns)
    lbA: torch.Tensor      # (B, N, r)   (-inf = absent)
    ubA: torch.Tensor      # (B, N, r)   (+inf = absent)
    u_lb: torch.Tensor     # (B, N, nu)
    u_ub: torch.Tensor     # (B, N, nu)
    s_lb: torch.Tensor     # (B, ns)
    s_ub: torch.Tensor     # (B, ns)


@dataclasses.dataclass(frozen=True)
class StageIpmResult:
    u: torch.Tensor            # (B, N, nu)
    x: torch.Tensor            # (B, N, nx)  optimal x_1..x_N
    s: torch.Tensor            # (B, ns)
    lam: torch.Tensor          # (B, N, nx)  equality multipliers (unscaled)
    z_u: torch.Tensor          # (B, N, nu)  combined control-bound dual
    z_s: torch.Tensor          # (B, ns)     combined slack-bound dual
    z_rows: torch.Tensor       # (B, N, r)   combined row dual
    iterations: torch.Tensor   # (B,) int32
    mu: torch.Tensor           # (B,)
    primal_res: torch.Tensor   # (B,)
    dual_res: torch.Tensor     # (B,)
    objective: torch.Tensor    # (B,)


# ---------------------------------------------------------------------------
# Riccati factor / apply (dispatch to the kernels or their plain versions)
# ---------------------------------------------------------------------------


def riccati_factor(Ad, Bd, Qb, Rb, M):
    """Riccati factorisation, batch-first (``kernels.riccati.factor``)."""
    return kriccati.factor(Ad, Bd, Qb, Rb, M)


def riccati_apply(fac, Ad, Bd, M, rx, ru, re):
    """Riccati substitution for (B, K, N, n) right-hand sides."""
    Huinv, G, W = fac
    return kriccati.apply(Huinv, G, W, Ad, Bd, M, rx, ru, re)


def assemble_factor(C, D, Ws, D_r, qb_diag, rb_diag, Ad, Bd):
    """Quadform assembly + Riccati factorisation in one sweep."""
    return kriccati.assemble_factor(C, D, Ws, D_r, qb_diag, rb_diag, Ad, Bd)


# ---------------------------------------------------------------------------
# the solver
# ---------------------------------------------------------------------------

# IpmOptions fields with no stage-wise analogue: they compensate for the
# condensed Hessian's conditioning, which the stage-wise KKT system never
# forms.  Setting any of them non-default here is a configuration error.
_UNSUPPORTED_STAGE_OPTS = ("polish", "scale_kkt", "comp_resid",
                           "correctors", "var_scale")


def _check_stage_opts(opts: IpmOptions) -> None:
    defaults = IpmOptions()
    bad = [f for f in _UNSUPPORTED_STAGE_OPTS
           if getattr(opts, f) != getattr(defaults, f)]
    if bad:
        raise ValueError(
            f"IpmOptions fields {bad} are condensed-only and have no "
            "effect in the stage-wise Riccati solver; clear them (the "
            "supported accuracy refinement here is refine_restart)")


def _delta_stage_qp(qp: StageQP, res: StageIpmResult) -> StageQP:
    """Restate ``qp`` in DELTA FORM about the incumbent ``res``: the
    incumbent's equality residual as the dynamics offset, row bounds
    shifted by the compensated row values, re-anchored cost gradients and
    shifted variable bounds -- all with error-free transforms, so the
    delta solve works at full f32 relative precision."""
    ns = qp.g_s.shape[-1]
    u, x, s = res.u, res.x, res.s

    h1, l1 = residual_affine(qp.C, x, torch.zeros_like(qp.lbA))
    y_hi, l2 = residual_affine(qp.D, u, h1)
    if ns:
        s_st = s[:, None, :].expand(-1, qp.C.shape[1], -1)
        y_hi, l3 = residual_affine(qp.Ws, s_st, y_hi)
        l2 = l2 + l3
    y_lo = l1 + l2
    lbA_d = (qp.lbA - y_hi) - y_lo
    ubA_d = (qp.ubA - y_hi) - y_lo

    x_prev = torch.cat([qp.x0[:, None], x[:, :-1]], 1)
    e1, m1 = residual_affine(qp.Ad, x_prev, qp.dd)
    e2, m2 = residual_affine(qp.Bd, u, e1)
    dd_d = (e2 - x) + (m1 + m2)

    return dataclasses.replace(
        qp,
        dd=dd_d, x0=torch.zeros_like(qp.x0),
        qx=fma_add(qp.Qx, x, qp.qx),
        ru=fma_add(qp.Ru, u, qp.ru),
        lbA=lbA_d, ubA=ubA_d,
        u_lb=qp.u_lb - u, u_ub=qp.u_ub - u,
        s_lb=qp.s_lb - s, s_ub=qp.s_ub - s)


@_highest_precision
def solve_stage_qp(qp: StageQP, opts: IpmOptions = IpmOptions(),
                   warm: StageIpmResult | None = None) -> StageIpmResult:
    """Solve a batch of stage-wise QPs.

    Reads the stage-wise fields of :class:`ops.ipm.IpmOptions`;
    ``refine_restart`` adds delta-form re-solves about the incumbent.  The
    soft-slack variables are rescaled by a power of two per instance so
    the slack gradient no longer sets the global objective scale; results
    are reported in original units except the residuals.  The
    condensed-only fields (``polish``, ``scale_kkt``, ``comp_resid``,
    ``correctors``, ``var_scale``) raise ``ValueError`` when set.  On a
    CUDA device, a problem the kernels cannot run (not float32, nu != 2,
    nx or ns outside what they take) raises ``ValueError`` before any
    launch (``kernels.riccati.check_entry``).
    """
    _check_stage_opts(opts)
    ns = qp.g_s.shape[-1]
    kriccati.check_entry(qp.Ad.device, qp.Ad.dtype, qp.Ad.shape[-1],
                         qp.Bd.shape[-1], ns)
    if ns:
        gx = torch.maximum(
            torch.maximum(_amax(qp.Qx.abs()), _amax(qp.qx.abs())),
            torch.clamp_min(_amax(qp.Ru.abs()), 1.0))
        ss = torch.clamp_max(
            _pow2(gx / torch.clamp_min(_amax(qp.g_s.abs()), 1.0)), 1.0)
        s1 = ss[:, None]
        qp = dataclasses.replace(qp, g_s=qp.g_s * s1,
                                 Ws=qp.Ws * _bc(ss, qp.Ws),
                                 s_lb=qp.s_lb / s1, s_ub=qp.s_ub / s1)
        if warm is not None:
            warm = dataclasses.replace(warm, s=warm.s / s1,
                                       z_s=warm.z_s * s1)
        res = _solve_scaled(qp, opts, warm)
        return dataclasses.replace(res, s=res.s * s1, z_s=res.z_s / s1)
    return _solve_scaled(qp, opts, warm)


def _solve_scaled(qp: StageQP, opts: IpmOptions,
                  warm: StageIpmResult | None) -> StageIpmResult:
    """The solve plus its delta-form restart rounds, on the slack-scaled
    problem."""
    if not opts.refine_restart:
        return _solve_stage_core(qp, opts, warm)

    o1 = dataclasses.replace(opts, refine_restart=0)
    res = _solve_stage_core(qp, o1, warm)
    o2 = dataclasses.replace(
        opts, refine_restart=0, max_iters=opts.refine_iters,
        warm_duals="reuse", warm_floor=1e-7)
    ns = qp.g_s.shape[-1]
    # merit weight: the largest unscaled gradient magnitude
    W = torch.maximum(
        _amax(qp.g_s.abs()) if ns else torch.zeros_like(qp.x0[:, 0]),
        torch.maximum(_amax(qp.qx.abs()), _amax(qp.ru.abs()))) + 1.0
    for _ in range(int(opts.refine_restart)):
        dqp = _delta_stage_qp(qp, res)
        warm2 = dataclasses.replace(
            res, u=torch.zeros_like(res.u), x=torch.zeros_like(res.x),
            s=torch.zeros_like(res.s))
        res2 = _solve_stage_core(dqp, o2, warm=warm2)

        # accept the round only if it improves an exact-penalty merit on
        # the compensated delta data (per instance)
        du, dx, ds = res2.u, res2.x, res2.s

        def _viol(du_, dx_, ds_):
            y = (torch.einsum("bnri,bni->bnr", dqp.C, dx_)
                 + torch.einsum("bnrk,bnk->bnr", dqp.D, du_))
            if ns:
                y = y + torch.einsum("bnrj,bj->bnr", dqp.Ws, ds_)
            v = torch.clamp_min(torch.maximum(dqp.lbA - y, y - dqp.ubA), 0.0)
            v = _amax(torch.where(torch.isfinite(v), v, 0.0))
            vu = torch.clamp_min(torch.maximum(dqp.u_lb - du_,
                                               du_ - dqp.u_ub), 0.0)
            v = torch.maximum(v, _amax(torch.where(torch.isfinite(vu), vu,
                                                   0.0)))
            if ns:
                vs = torch.clamp_min(torch.maximum(dqp.s_lb - ds_,
                                                   ds_ - dqp.s_ub), 0.0)
                v = torch.maximum(v, _amax(torch.where(torch.isfinite(vs),
                                                       vs, 0.0)))
            return v

        df = (_bsum(dqp.qx * dx) + 0.5 * _bsum(dqp.Qx * dx * dx)
              + _bsum(dqp.ru * du) + 0.5 * _bsum(dqp.Ru * du * du))
        if ns:
            df = df + _bsum(dqp.g_s * ds)
        dmerit = df + W * (_viol(du, dx, ds)
                           - _viol(torch.zeros_like(du),
                                   torch.zeros_like(dx),
                                   torch.zeros_like(ds)))
        ok = (_all_finite(du) & _all_finite(dx) & _all_finite(ds)
              & (dmerit <= 1e-3 * W))
        u_n, x_n, s_n = res.u + du, res.x + dx, res.s + ds
        obj = (0.5 * _bsum(qp.Qx * x_n * x_n) + _bsum(qp.qx * x_n)
               + 0.5 * _bsum(qp.Ru * u_n * u_n) + _bsum(qp.ru * u_n))
        if ns:
            obj = obj + _bsum(qp.g_s * s_n)
        pick = lambda a, b: _where(ok, a, b)
        res = StageIpmResult(
            u=pick(u_n, res.u), x=pick(x_n, res.x), s=pick(s_n, res.s),
            lam=pick(res2.lam, res.lam),
            z_u=pick(res2.z_u, res.z_u), z_s=pick(res2.z_s, res.z_s),
            z_rows=pick(res2.z_rows, res.z_rows),
            iterations=res.iterations + res2.iterations,
            mu=pick(res2.mu, res.mu),
            primal_res=pick(res2.primal_res, res.primal_res),
            dual_res=pick(res2.dual_res, res.dual_res),
            objective=pick(obj, res.objective))
    return res


@_highest_precision
def _solve_stage_core(qp: StageQP, opts: IpmOptions = IpmOptions(),
                      warm: StageIpmResult | None = None) -> StageIpmResult:
    """One plain stage-wise IPM solve (no restart handling; see
    :func:`solve_stage_qp`)."""
    Bsz, N, r, nx = qp.C.shape
    nu = qp.Bd.shape[-1]
    ns = qp.g_s.shape[-1]
    dtype, dev = qp.Ad.dtype, qp.Ad.device
    zero_b = torch.zeros((Bsz,), dtype=dtype, device=dev)

    # ---- objective scaling (pow2: roundoff-free), per instance ------------
    gmax = torch.maximum(
        torch.maximum(_amax(qp.Qx.abs()), _amax(qp.qx.abs())),
        torch.maximum(_amax(qp.Ru.abs()),
                      _amax(qp.g_s.abs()) if ns else zero_b))
    c_scale = _pow2(1.0 / torch.clamp_min(gmax, 1.0))          # (B,)
    c3 = c_scale[:, None, None]
    Qx = qp.Qx * c3
    qx = qp.qx * c3
    Ru = qp.Ru * c3
    ru_lin = qp.ru * c3
    g_s = qp.g_s * c_scale[:, None]

    # ---- row equilibration (pow2 of the 2-norm) ----------------------------
    if opts.equilibrate:
        n2 = ((qp.C ** 2).sum(-1) + (qp.D ** 2).sum(-1)
              + (qp.Ws ** 2).sum(-1))
        r_scale = _pow2(torch.rsqrt(torch.clamp_min(n2, 1e-24)))   # (B,N,r)
    else:
        r_scale = torch.ones((Bsz, N, r), dtype=dtype, device=dev)
    C = qp.C * r_scale[..., None]
    D = qp.D * r_scale[..., None]
    Ws = qp.Ws * r_scale[..., None]
    lbA = qp.lbA * r_scale
    ubA = qp.ubA * r_scale

    # ---- masks -------------------------------------------------------------
    mrl, lbA_s = _side(lbA)
    mru, ubA_s = _side(ubA)
    mul, u_lb = _side(qp.u_lb)
    muu, u_ub = _side(qp.u_ub)
    msl, s_lb = _side(qp.s_lb)
    msu, s_ub = _side(qp.s_ub)
    masks = (mrl, mru, mul, muu, msl, msu)
    n_active = sum(_bsum(m.to(torch.int64)) for m in masks)
    n_active = torch.clamp_min(n_active, 1).to(dtype)              # (B,)

    Ad, Bd, dd, x0 = (qp.Ad.contiguous(), qp.Bd.contiguous(), qp.dd,
                      qp.x0)
    eye_x = torch.eye(nx, dtype=dtype, device=dev)
    eye_u = torch.eye(nu, dtype=dtype, device=dev)
    maxdiag = 1.0 + torch.maximum(_amax(Qx), _amax(Ru))            # (B,)
    d_cap = D_CAP_F64 if torch.finfo(dtype).eps < 1e-10 else D_CAP_F32
    inf = float("inf")

    def rows_of(x, u, s):
        y = (torch.einsum("bnri,bni->bnr", C, x)
             + torch.einsum("bnrk,bnk->bnr", D, u))
        if ns:
            y = y + torch.einsum("bnrj,bj->bnr", Ws, s)
        return y

    def adjoint_lam(x, z_r):
        """Equality multipliers that zero the x-stationarity residual at
        (x, z_r): lam_k = Qx_k x_k + qx_k + Ad_{k+1}' lam_{k+1} - C_k' z_k."""
        base = Qx * x + qx - torch.einsum("bnri,bnr->bni", C, z_r)
        lams = [None] * N
        lams[N - 1] = lam = base[:, N - 1]
        for k in reversed(range(N - 1)):
            lam = base[:, k] + torch.einsum("bji,bj->bi", Ad[:, k + 1], lam)
            lams[k] = lam
        return torch.stack(lams, 1)

    def x_prev_of(x):
        return torch.cat([x0[:, None], x[:, :-1]], 1)

    # ---- Newton solve given current diagonal weights -----------------------
    def factor_and_columns(D_r, D_u, D_s, regm, rhs_p):
        """Riccati factorisation + sigma Schur data for one iteration; the
        predictor rhs rides the same K = ns + 1 apply as the ns sigma
        columns."""
        reg = opts.reg * regm * maxdiag                              # (B,)
        reg3 = reg[:, None, None]
        Huinv_f, G_f, W_f, Mq, Lx, Lu, Hss_st = assemble_factor(
            C, D, Ws, D_r, Qx + reg3, Ru + D_u + reg3, Ad, Bd)
        fac = (Huinv_f, G_f, W_f)
        rhs_x_p, rhs_u_p, re_p = rhs_p
        if ns:
            Hss = (Hss_st.sum(1) + torch.diag_embed(D_s)
                   + reg3 * torch.eye(ns, dtype=dtype, device=dev))
            rx_all = torch.cat([Lx.permute(0, 3, 1, 2), rhs_x_p[:, None]], 1)
            ru_all = torch.cat([Lu.permute(0, 3, 1, 2), rhs_u_p[:, None]], 1)
            re_all = torch.cat(
                [torch.zeros((Bsz, ns, N, nx), dtype=dtype, device=dev),
                 re_p[:, None]], 1)
            Yu_a, Yx_a, Yl_a = riccati_apply(fac, Ad, Bd, Mq, rx_all,
                                             ru_all, re_all)
            Yu, Yx, Yl = Yu_a[:, :ns], Yx_a[:, :ns], Yl_a[:, :ns]
            pred0 = (Yu_a[:, ns], Yx_a[:, ns], Yl_a[:, ns])
            # Schur complement  S = Hss - L' K^-1 L
            LtY = (torch.einsum("bnij,bkni->bjk", Lx, Yx)
                   + torch.einsum("bnuj,bknu->bjk", Lu, Yu))
            S = Hss - 0.5 * (LtY + LtY.transpose(-1, -2))
            S_chol = _chol_small(S)
        else:
            du0, dx0_, dl0 = riccati_apply(
                fac, Ad, Bd, Mq, rhs_x_p[:, None].contiguous(),
                rhs_u_p[:, None].contiguous(), re_p[:, None].contiguous())
            pred0 = (du0[:, 0], dx0_[:, 0], dl0[:, 0])
            Lx = Lu = Yu = Yx = Yl = S_chol = None
        return (fac, Mq, Lx, Lu, Yu, Yx, Yl, S_chol), pred0

    def schur_correct(facdata, base, rhs_s):
        """Back out the sigma step and correct a base solution."""
        fac, Mq, Lx, Lu, Yu, Yx, Yl, S_chol = facdata
        du0, dx0_, dl0 = base
        if ns:
            Ltv = (torch.einsum("bnij,bni->bj", Lx, dx0_)
                   + torch.einsum("bnuj,bnu->bj", Lu, du0))
            dsg = _cho_solve_small(S_chol, rhs_s - Ltv)
            du = du0 - torch.einsum("bjnk,bj->bnk", Yu, dsg)
            dx = dx0_ - torch.einsum("bjni,bj->bni", Yx, dsg)
            dlam = dl0 - torch.einsum("bjni,bj->bni", Yl, dsg)
        else:
            dsg = torch.zeros((Bsz, ns), dtype=dtype, device=dev)
            du, dx, dlam = du0, dx0_, dl0
        return du, dx, dlam, dsg

    def kkt_solve(facdata, rhs_x, rhs_u, rhs_s, re):
        """Solve the full KKT (incl. sigma Schur) for ONE rhs."""
        fac, Mq = facdata[0], facdata[1]
        du0, dx0_, dl0 = riccati_apply(
            fac, Ad, Bd, Mq, rhs_x[:, None].contiguous(),
            rhs_u[:, None].contiguous(), re[:, None].contiguous())
        return schur_correct(facdata, (du0[:, 0], dx0_[:, 0], dl0[:, 0]),
                             rhs_s)

    # ---- residuals ---------------------------------------------------------
    def residuals(state):
        (u, x, s, _, (srl, sru, sul, suu, ssl, ssu),
         (zrl, zru, zul, zuu, zsl, zsu)) = state
        y = rows_of(x, u, s)
        z_r = zrl - zru
        # lam is always the exact adjoint of the current (x, z_r)
        lam = adjoint_lam(x, z_r)
        r_du = (Ru * u + ru_lin + torch.einsum("bnik,bni->bnk", Bd, lam)
                - (zul - zuu) - torch.einsum("bnrk,bnr->bnk", D, z_r))
        adj = torch.einsum("bnij,bni->bnj", Ad[:, 1:], lam[:, 1:])
        adj = torch.cat([adj, torch.zeros((Bsz, 1, nx), dtype=dtype,
                                          device=dev)], 1)
        r_dx = (Qx * x + qx - lam + adj
                - torch.einsum("bnri,bnr->bni", C, z_r))
        r_ds = g_s - (zsl - zsu) - torch.einsum("bnrj,bnr->bj", Ws, z_r)
        r_eq = (torch.einsum("bnij,bnj->bni", Ad, x_prev_of(x))
                + torch.einsum("bnik,bnk->bni", Bd, u) + dd - x)
        r_prl = torch.where(mrl, srl - (y - lbA_s), 0.0)
        r_pru = torch.where(mru, sru - (ubA_s - y), 0.0)
        r_pul = torch.where(mul, sul - (u - u_lb), 0.0)
        r_puu = torch.where(muu, suu - (u_ub - u), 0.0)
        r_psl = torch.where(msl, ssl - (s - s_lb), 0.0)
        r_psu = torch.where(msu, ssu - (s_ub - s), 0.0)
        return (r_du, r_dx, r_ds, r_eq,
                (r_prl, r_pru, r_pul, r_puu, r_psl, r_psu))

    def pres_of(r_eq, rp):
        r_prl, r_pru, r_pul, r_puu, r_psl, r_psu = rp
        m = torch.maximum(_amax((r_prl / r_scale).abs()),
                          _amax((r_pru / r_scale).abs()))
        m = torch.maximum(m, _amax(r_pul.abs()))
        m = torch.maximum(m, _amax(r_puu.abs()))
        if ns:
            m = torch.maximum(m, torch.maximum(_amax(r_psl.abs()),
                                               _amax(r_psu.abs())))
        return torch.maximum(m, _amax(r_eq.abs()))

    def dres_of(r_du, r_dx, r_ds):
        m = torch.maximum(_amax(r_du.abs()), _amax(r_dx.abs()))
        if ns:
            m = torch.maximum(m, _amax(r_ds.abs()))
        return m

    def mu_of(state):
        S, Z = state[4], state[5]
        tot = sum(_bsum(torch.where(mk, s_ * z_, 0.0))
                  for mk, s_, z_ in zip(masks, S, Z))
        return tot / n_active

    def score_of(state):
        r_du, r_dx, r_ds, r_eq, rp = residuals(state)
        return (pres_of(r_eq, rp) + 10.0 * dres_of(r_du, r_dx, r_ds)
                + mu_of(state))

    def clip_u(u):
        return torch.minimum(torch.maximum(u, torch.where(mul, u_lb, -inf)),
                             torch.where(muu, u_ub, inf))

    # ---- initial point -----------------------------------------------------
    def init_solve():
        """Equality-constrained minimiser via one regularised Riccati
        solve (the stage-wise centered initialisation)."""
        shift0 = 1e-3 if torch.finfo(dtype).eps > 1e-10 else 1e-8
        reg0 = (shift0 * maxdiag)[:, None, None, None]
        Qb0 = torch.diag_embed(Qx) + reg0 * eye_x
        Rb0 = torch.diag_embed(Ru) + reg0 * eye_u
        M0 = torch.zeros((Bsz, N, nx, nu), dtype=dtype, device=dev)
        fac0 = riccati_factor(Ad, Bd, Qb0.contiguous(), Rb0.contiguous(), M0)
        re0 = torch.cat(
            [(dd[:, 0] + torch.einsum("bij,bj->bi", Ad[:, 0], x0))[:, None],
             dd[:, 1:]], 1)
        u_i, x_i, lam_i = riccati_apply(
            fac0, Ad, Bd, M0, (-qx)[:, None].contiguous(),
            (-ru_lin)[:, None].contiguous(), re0[:, None].contiguous())
        return u_i[:, 0], x_i[:, 0], lam_i[:, 0]

    if warm is None and opts.init == "centered":
        u0_, x0_, _ = init_solve()
        ok = _all_finite(u0_) & _all_finite(x0_)
        u0_ = torch.where(_bc(ok, u0_), u0_, 0.0)
        u0_ = clip_u(u0_)
        x0_ = rollout(Ad, Bd, dd, x0, u0_)
        s0_ = torch.zeros((Bsz, ns), dtype=dtype, device=dev)
        mu0 = opts.mu0
    elif warm is not None:
        # warm primal: controls + slacks carry over, the states are
        # re-rolled under this tick's dynamics
        u0_ = clip_u(warm.u)
        x0_ = rollout(Ad, Bd, dd, x0, u0_)
        s0_ = warm.s
        mu0 = opts.warm_mu0
    else:
        u0_ = torch.zeros((Bsz, N, nu), dtype=dtype, device=dev)
        x0_ = rollout(Ad, Bd, dd, x0, u0_)
        s0_ = torch.zeros((Bsz, ns), dtype=dtype, device=dev)
        mu0 = opts.mu0
    s_init0 = s0_
    y0 = rows_of(x0_, u0_, s_init0)
    raw = [torch.where(mrl, y0 - lbA_s, inf),
           torch.where(mru, ubA_s - y0, inf),
           torch.where(mul, u0_ - u_lb, inf),
           torch.where(muu, u_ub - u0_, inf),
           torch.where(msl, s_init0 - s_lb, inf),
           torch.where(msu, s_ub - s_init0, inf)]
    if warm is None:
        # Mehrotra-style global positive shift, duals on the central path
        smin = torch.minimum(
            torch.minimum(torch.minimum(_amin(raw[0]), _amin(raw[1])),
                          torch.minimum(_amin(raw[2]), _amin(raw[3]))),
            torch.minimum(_amin(raw[4]), _amin(raw[5])))
        shift = torch.clamp_min(-1.5 * smin, 0.0) + 1e-2          # (B,)
        S0 = tuple(torch.where(mk, rw + _bc(shift, rw), 1.0)
                   for mk, rw in zip(masks, raw))
    elif opts.warm_duals == "reuse":
        # delta-form restart regime: reuse the incumbent's duals with a tiny
        # positivity floor, brought into this solve's scaling
        fl = opts.warm_floor
        S0 = tuple(torch.where(mk, torch.clamp_min(rw, fl), 1.0)
                   for mk, rw in zip(masks, raw))
        wz_r = warm.z_rows * c3 / r_scale
        wz_u = warm.z_u * c3
        wz_s = warm.z_s * c_scale[:, None]
        Z0 = tuple(torch.where(mk, torch.clamp_min(sgn * wz, fl), 0.0)
                   for mk, wz, sgn in [(mrl, wz_r, 1.0), (mru, wz_r, -1.0),
                                       (mul, wz_u, 1.0), (muu, wz_u, -1.0),
                                       (msl, wz_s, 1.0), (msu, wz_s, -1.0)])
    else:
        # per-element floor for warm starts
        S0 = tuple(torch.where(mk, torch.clamp_min(rw, 1e-2), 1.0)
                   for mk, rw in zip(masks, raw))
    if not (warm is not None and opts.warm_duals == "reuse"):
        Z0 = tuple(torch.where(mk, mu0 / s_, 0.0)
                   for mk, s_ in zip(masks, S0))
    lam0 = adjoint_lam(x0_, Z0[0] - Z0[1])
    state0 = (u0_, x0_, s_init0, lam0, S0, Z0)

    # ---- one Mehrotra iteration --------------------------------------------
    def iterate(state, regm):
        (u, x, s, lam, S, Z) = state
        srl, sru, sul, suu, ssl, ssu = S
        zrl, zru, zul, zuu, zsl, zsu = Z
        mu = mu_of(state)
        r_du, r_dx, r_ds, r_eq, rp = residuals(state)
        r_prl, r_pru, r_pul, r_puu, r_psl, r_psu = rp
        pres_in = pres_of(r_eq, rp)
        dres_in = dres_of(r_du, r_dx, r_ds)
        score_in = pres_in + 10.0 * dres_in + mu

        if opts.freeze is not None:
            fp, fd, fm = opts.freeze
            frozen = (pres_in < fp) & (dres_in < fd) & (mu < fm)
        else:
            frozen = torch.zeros((Bsz,), dtype=torch.bool, device=dev)

        clipd = lambda z_, s_, mk: torch.clamp(
            torch.where(mk, z_ / s_, 0.0), 0.0, d_cap)
        drl, dru = clipd(zrl, srl, mrl), clipd(zru, sru, mru)
        dul, duu = clipd(zul, sul, mul), clipd(zuu, suu, muu)
        dsl, dsu = clipd(zsl, ssl, msl), clipd(zsu, ssu, msu)
        D_r = drl + dru
        D_u = dul + duu
        D_s = dsl + dsu

        def build_rhs(rc):
            rc_rl, rc_ru, rc_ul, rc_uu, rc_sl, rc_su = rc
            t_r = (torch.where(mrl, (rc_rl + zrl * r_prl) / srl, 0.0)
                   - torch.where(mru, (rc_ru + zru * r_pru) / sru, 0.0))
            t_u = (torch.where(mul, (rc_ul + zul * r_pul) / sul, 0.0)
                   - torch.where(muu, (rc_uu + zuu * r_puu) / suu, 0.0))
            t_s = (torch.where(msl, (rc_sl + zsl * r_psl) / ssl, 0.0)
                   - torch.where(msu, (rc_su + zsu * r_psu) / ssu, 0.0))
            rhs_u = -r_du + t_u + torch.einsum("bnrk,bnr->bnk", D, t_r)
            rhs_x = -r_dx + torch.einsum("bnri,bnr->bni", C, t_r)
            rhs_s = -r_ds + t_s + torch.einsum("bnrj,bnr->bj", Ws, t_r)
            return rhs_x, rhs_u, rhs_s

        def finish(dv4, rc):
            rc_rl, rc_ru, rc_ul, rc_uu, rc_sl, rc_su = rc
            du, dx, dlam, dsg = dv4
            dy = rows_of(dx, du, dsg)      # rows_of is linear
            dsrl = torch.where(mrl, dy - r_prl, 0.0)
            dsru = torch.where(mru, -dy - r_pru, 0.0)
            dsul = torch.where(mul, du - r_pul, 0.0)
            dsuu = torch.where(muu, -du - r_puu, 0.0)
            dssl = torch.where(msl, dsg - r_psl, 0.0)
            dssu = torch.where(msu, -dsg - r_psu, 0.0)
            dS = (dsrl, dsru, dsul, dsuu, dssl, dssu)
            dz = lambda rc_, z_, s_, ds_, mk: torch.where(
                mk, (rc_ - z_ * ds_) / s_, 0.0)
            dZ = (dz(rc_rl, zrl, srl, dsrl, mrl),
                  dz(rc_ru, zru, sru, dsru, mru),
                  dz(rc_ul, zul, sul, dsul, mul),
                  dz(rc_uu, zuu, suu, dsuu, muu),
                  dz(rc_sl, zsl, ssl, dssl, msl),
                  dz(rc_su, zsu, ssu, dssu, msu))
            return (du, dx, dsg, dlam), dS, dZ

        def full_solve(rc):
            rhs_x, rhs_u, rhs_s = build_rhs(rc)
            dv4 = kkt_solve(facdata, rhs_x, rhs_u, rhs_s, -r_eq)
            return finish(dv4, rc)

        def max_step(s_, ds_, mk):
            lim = torch.where(mk & (ds_ < 0),
                              -opts.tau * s_ / torch.clamp_max(ds_, -1e-30),
                              1.0)
            return _amin(lim)

        def steps_of(dS, dZ):
            a_p = torch.ones((Bsz,), dtype=dtype, device=dev)
            a_d = torch.ones((Bsz,), dtype=dtype, device=dev)
            for mk, s_, ds_ in zip(masks, S, dS):
                a_p = torch.minimum(a_p, max_step(s_, ds_, mk))
            for mk, z_, dz_ in zip(masks, Z, dZ):
                a_d = torch.minimum(a_d, max_step(z_, dz_, mk))
            return torch.clamp_max(a_p, 1.0), torch.clamp_max(a_d, 1.0)

        # predictor -- its rhs rides the sigma-columns apply sweep
        rc_aff = tuple(torch.where(mk, -s_ * z_, 0.0)
                       for mk, s_, z_ in zip(masks, S, Z))
        rhs_aff = build_rhs(rc_aff)
        facdata, pred0 = factor_and_columns(
            D_r, D_u, D_s, regm, (rhs_aff[0], rhs_aff[1], -r_eq))
        dv4_a = schur_correct(facdata, pred0, rhs_aff[2])
        dv_a, dS_a, dZ_a = finish(dv4_a, rc_aff)
        a_p, a_d = steps_of(dS_a, dZ_a)
        tot_aff = sum(
            _bsum(torch.where(mk, (s_ + _bc(a_p, s_) * ds_)
                              * (z_ + _bc(a_d, z_) * dz_), 0.0))
            for mk, s_, ds_, z_, dz_ in zip(masks, S, dS_a, Z, dZ_a))
        mu_aff = tot_aff / n_active
        sigma = torch.clamp((mu_aff / torch.clamp_min(mu, 1e-300)) ** 3,
                            0.0, 1.0)

        # corrector
        rc_c = tuple(
            torch.where(mk, _bc(sigma * mu, s_) - s_ * z_ - ds_ * dz_, 0.0)
            for mk, s_, z_, ds_, dz_ in zip(masks, S, Z, dS_a, dZ_a))
        dv, dS, dZ = full_solve(rc_c)
        a_p, a_d = steps_of(dS, dZ)

        du, dx, dsg, dlam = dv
        ap = lambda t: _bc(a_p, t)
        ad = lambda t: _bc(a_d, t)
        u_n = u + ap(du) * du
        x_n = x + ap(dx) * dx
        s_n = s + ap(dsg) * dsg
        lam_n = lam + ad(dlam) * dlam
        S_n = tuple(torch.where(mk, s_ + ap(ds_) * ds_, 1.0)
                    for mk, s_, ds_ in zip(masks, S, dS))
        Z_n = tuple(torch.where(mk, z_ + ad(dz_) * dz_, 0.0)
                    for mk, z_, dz_ in zip(masks, Z, dZ))
        new = (u_n, x_n, s_n, lam_n, S_n, Z_n)
        finite = torch.stack([_all_finite(v) for v in _leaves(new)]).all(0)
        good = finite & torch.logical_not(frozen)
        kept = _where(good, new, state)
        return kept, good, score_in

    def regm_next(regm, good):
        return torch.where(good, torch.clamp_min(regm * 0.1, 1.0),
                           torch.clamp_max(regm * 100.0, 1e12))

    def converged(state):
        r_du, r_dx, r_ds, r_eq, rp = residuals(state)
        return ((pres_of(r_eq, rp) < opts.tol)
                & (dres_of(r_du, r_dx, r_ds) < opts.tol)
                & (mu_of(state) < opts.tol))

    state, best = state0, state0
    bscore = torch.full((Bsz,), inf, dtype=dtype, device=dev)
    regm = torch.ones((Bsz,), dtype=dtype, device=dev)
    if opts.adaptive:
        # the batched while-loop: an instance stops (its carry is kept) once
        # it has converged; the loop ends when every instance has
        iters = torch.zeros((Bsz,), dtype=torch.int32, device=dev)
        for _ in range(opts.max_iters):
            active = torch.logical_not(converged(state))
            if not bool(active.any()):
                break
            new_state, good, sc = iterate(state, regm)
            better = sc < bscore
            best = _where(active & better, state, best)
            bscore = torch.where(active & better, sc, bscore)
            regm = torch.where(active, regm_next(regm, good), regm)
            state = _where(active, new_state, state)
            iters = iters + active.to(torch.int32)
    else:
        for _ in range(opts.max_iters):
            new_state, good, sc = iterate(state, regm)
            better = sc < bscore
            best = _where(better, state, best)
            bscore = torch.where(better, sc, bscore)
            regm = regm_next(regm, good)
            state = new_state
        iters = torch.full((Bsz,), opts.max_iters, dtype=torch.int32,
                           device=dev)

    final_better = score_of(state) < bscore
    state = _where(final_better, state, best)

    (u, x, s, _, S, Z) = state
    zrl, zru, zul, zuu, zsl, zsu = Z
    lam = adjoint_lam(x, zrl - zru)
    r_du, r_dx, r_ds, r_eq, rp = residuals(state)
    obj = (0.5 * _bsum(qp.Qx * x * x) + _bsum(qp.qx * x)
           + 0.5 * _bsum(qp.Ru * u * u) + _bsum(qp.ru * u))
    if ns:
        obj = obj + _bsum(qp.g_s * s)
    return StageIpmResult(
        u=u, x=x, s=s, lam=lam / c3,
        z_u=(zul - zuu) / c3,
        z_s=(zsl - zsu) / c_scale[:, None],
        z_rows=(zrl - zru) * r_scale / c3,
        iterations=iters,
        mu=mu_of(state) / c_scale,
        primal_res=pres_of(r_eq, rp),
        dual_res=dres_of(r_du, r_dx, r_ds) / c_scale,
        objective=obj)
