"""Batched dense primal-dual interior-point QP solver (port of
``fsae_mpc_tpu.ops.ipm``): options, presets and :func:`solve_qp`.

Solves, for every instance b of a batch,

    min  1/2 x' H x + g' x
    s.t. lb  <=  x  <= ub          (variable bounds)
         lbA <= A x <= ubA         (general rows)

with a Mehrotra predictor-corrector interior-point method: two-sided
slacks with masked infinite sides, one dense Cholesky factorisation of
``H + A' D A + D_b`` per iteration shared by predictor and corrector, and
power-of-two objective and row scalings.  The JAX solver is written per
instance and ``vmap``ped; here the batch is written out: every tensor has
a leading batch dimension B, every reduction of the JAX code
(``max``/``min``/``sum``/``all``) is taken over one instance, and every
selection (freeze, finite-iterate rejection, best iterate, correctors,
polish, restart gate) is made per instance.

The KKT factorisations and solves go through ``ops/kernels/chol.py``
(``chol="auto"``: the hand-written kernels on CUDA tensors, their plain
versions on CPU tensors).  With ``opts.adaptive=False`` (the f32 presets)
a solve is a fixed sequence of device work with no host synchronisation.

``IpmOptions`` is also what the stage-wise solver (``ops/riccati.py``)
reads; field names and defaults are the JAX package's.
"""

from __future__ import annotations

import dataclasses

import torch

from .kernels import chol as kchol
from .precision import highest as _highest_precision
from .precision import residual_affine


def _pow2(x):
    """Round a positive scale factor DOWN to the nearest power of two.

    Scaling by exact powers of two is roundoff-free in binary floating
    point, so the scaled problem's optimum is exactly the original's.
    """
    return torch.exp2(torch.floor(torch.log2(x)))


@dataclasses.dataclass(frozen=True)
class IpmOptions:
    max_iters: int = 50
    tol: float = 5e-14          # residual tolerance on the scaled problem
    tau: float = 0.995          # fraction-to-boundary
    reg: float = 1e-9           # static KKT regularisation (relative to diag)
    s_init: float = 1.0         # initial slack floor ("basic" init)
    z_init: float = 1.0         # initial dual value ("basic" init)
    adaptive: bool = True       # early exit once every instance converged
                                # (False: fixed iteration count, no host sync)
    freeze: tuple | None = None  # (pres, dres, mu) scaled thresholds past
                                # which an instance's iterate is frozen
    chol: str = "auto"          # dense KKT factorisation: "auto" (the
                                # hand kernels on CUDA tensors, their plain
                                # versions on CPU tensors), "lapack" (the
                                # plain versions); the JAX package's
                                # "blocked" (a TPU VMEM workaround) raises
                                # ValueError
    equilibrate: bool = True    # scale general rows by a power of two of
                                # their inf-norm (dense) / 2-norm (stage)
    init: str = "centered"      # "centered" | "basic"
    mu0: float = 1.0            # initial centrality target (scaled problem)
    warm_duals: str = "centered"  # "centered" | "reuse"
    warm_mu0: float = 1e-2      # centrality target for warm starts
    warm_floor: float = 1e-3    # slack/dual positivity floor for warm starts
    correctors: int = 0         # Gondzio centrality correctors per iteration
    polish: int = 0             # active-set polish iterations after the IPM
    polish_rho: float = 1e3     # polish AL penalty cap (scaled units)
    var_scale: bool = False     # per-variable power-of-two equilibration
    scale_kkt: bool = False     # Jacobi-scaled KKT factorisation plus one
                                # refinement backsolve per solve
    refine_restart: int = 0     # delta-form restart rounds after the solve
    refine_iters: int = 10      # iteration budget per delta-form round
    refine_comp: bool = True    # compensated dual residuals inside the
                                # dense delta-form rounds
    comp_resid: bool = False    # compensated dual residuals in every
                                # dense iteration


# float32 throughput preset: fixed 12-iteration budget, matching tolerance,
# heavier regularisation, convergence freeze.
F32_OPTS = IpmOptions(max_iters=12, tol=5e-7, reg=1e-7, adaptive=False,
                      freeze=(1e-4, 1e-5, 1e-7))

# float32 accuracy preset of the dense solver: Jacobi-scaled KKT solves with
# a refinement backsolve, compensated dual residuals, one delta-form
# restart.
F32_ACCURATE = IpmOptions(max_iters=16, tol=5e-7, reg=1e-7, adaptive=False,
                          scale_kkt=True, comp_resid=True,
                          refine_restart=1, refine_iters=8)

# F32_OPTS plus one cheap delta-form restart round.
F32_BALANCED = IpmOptions(max_iters=12, tol=5e-7, reg=1e-7, adaptive=False,
                          freeze=(1e-4, 1e-5, 1e-7),
                          refine_restart=1, refine_iters=4)

# F32_OPTS plus two delta-form restart rounds of 6 iterations each, without
# compensated residuals inside the dense rounds.
F32_PRODUCTION = IpmOptions(max_iters=12, tol=5e-7, reg=1e-7,
                            adaptive=False, freeze=(1e-4, 1e-5, 1e-7),
                            refine_restart=2, refine_iters=6,
                            refine_comp=False)


# Caps on the complementarity diagonals z/s (both solvers): near
# convergence z/s grows without bound and the KKT matrix goes numerically
# indefinite; the cap bounds its condition number.
D_CAP_F64 = 1e14
D_CAP_F32 = 1e7


# ---------------------------------------------------------------------------
# per-instance reductions and selections (batch-first tensors)
# ---------------------------------------------------------------------------


def _flat(x):
    return x.reshape(x.shape[0], -1)


def _amax(x):
    return _flat(x).amax(1)


def _amin(x, empty=float("inf")):
    if x[0].numel() == 0:
        return torch.full(x.shape[:1], empty, dtype=x.dtype, device=x.device)
    return _flat(x).amin(1)


def _bsum(x):
    return _flat(x).sum(1)


def _all_finite(x):
    return torch.isfinite(_flat(x)).all(1)


def _bc(v, ref):
    """Reshape a per-instance (B,) tensor to broadcast against ``ref``."""
    return v.reshape(v.shape + (1,) * (ref.ndim - v.ndim))


def _where(cond, a, b):
    """Per-instance select over (nested tuples of) batch-first tensors."""
    if isinstance(a, tuple):
        return tuple(_where(cond, x, y) for x, y in zip(a, b))
    return torch.where(_bc(cond, a), a, b)


def _leaves(tree):
    if isinstance(tree, tuple):
        return [leaf for t in tree for leaf in _leaves(t)]
    return [tree]


# ---------------------------------------------------------------------------
# the dense solver
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class IpmResult:
    x: torch.Tensor            # (B, n) primal solution
    z_bounds: torch.Tensor     # (B, n) combined bound dual (z_l - z_u)
    z_rows: torch.Tensor       # (B, m) Hx + g - A'z_rows - z_bounds = 0
    iterations: torch.Tensor   # (B,) int32
    mu: torch.Tensor           # (B,) final complementarity measure
    primal_res: torch.Tensor   # (B,)
    dual_res: torch.Tensor     # (B,)
    objective: torch.Tensor    # (B,) 1/2 x'Hx + g'x (unscaled)


def _mv(A, x):
    return torch.einsum("bmn,bn->bm", A, x)


def _rmv(A, z):
    return torch.einsum("bmn,bm->bn", A, z)


def _qf(A, d):
    """A' diag(d) A, batched."""
    return torch.bmm(A.mT * d[:, None, :], A)


def _diag(K):
    return torch.diagonal(K, dim1=-2, dim2=-1)


def _objective(H, g, x):
    return 0.5 * _bsum(x * _mv(H, x)) + _bsum(g * x)


def _side(val):
    """Prepare one inequality side: finite mask and a safe bound value."""
    finite = torch.isfinite(val)
    return finite, torch.where(finite, val, 0.0)


def _chol_fns(chol: str):
    if chol == "auto":
        return kchol.factor, kchol.solve
    if chol == "lapack":
        return kchol.factor_ref, kchol.solve_ref
    if chol == "blocked":
        raise ValueError("chol='blocked' is the JAX package's workaround "
                         "for a TPU VMEM limit and has no counterpart in "
                         "the port; use 'auto' or 'lapack'")
    raise ValueError(f"unknown chol={chol!r}")


def _make_solver(K, chol: str, jacobi: bool):
    """Factor K (B, n, n) once and return a rhs -> K^-1 rhs closure.

    With ``jacobi``: symmetric Jacobi equilibration before the
    factorisation plus one iterative-refinement backsolve per solve."""
    factor, solve = _chol_fns(chol)
    if not jacobi:
        L = factor(K)
        return lambda r: solve(L, r)
    d = torch.rsqrt(torch.clamp_min(_diag(K), 1e-30))
    Ks = K * d[:, :, None] * d[:, None, :]
    L = factor(Ks)

    def solve2(r):
        r2 = d * r
        u = solve(L, r2)
        u = u + solve(L, r2 - _mv(Ks, u))
        return d * u

    return solve2


def _polish(state, Hs, gs, A, lb_s, ub_s, lbA_s, ubA_s, masks, opts,
            score_of):
    """Active-set polish: semismooth-Newton augmented Lagrangian on the
    scaled problem, with per-constraint penalties equal to the IPM's own
    ratios z/s capped at ``polish_rho``; kept per instance only if its
    optimality score beats the IPM iterate's."""
    mbl, mbu, mrl, mru = masks
    x0 = state[0]
    sbl, sbu, srl, sru = state[1], state[2], state[3], state[4]
    zbl, zbu, zrl, zru = state[5], state[6], state[7], state[8]
    rho = tuple(torch.where(mk, torch.clamp(z / s, 0.0, opts.polish_rho),
                            0.0)
                for mk, z, s in [(mbl, zbl, sbl), (mbu, zbu, sbu),
                                 (mrl, zrl, srl), (mru, zru, sru)])
    m = (torch.where(mbl, zbl, 0.0), torch.where(mbu, zbu, 0.0),
         torch.where(mrl, zrl, 0.0), torch.where(mru, zru, 0.0))
    reg = 10.0 * opts.reg * (1.0 + _amax(_diag(Hs).abs()))
    eye = torch.eye(Hs.shape[-1], dtype=Hs.dtype, device=Hs.device)

    def signed_slacks(x, y):
        return (x - lb_s, ub_s - x, y - lbA_s, ubA_s - y)

    # the Hessian of the weighted AL is constant: factor once
    K = (Hs + _qf(A, rho[2] + rho[3]) + torch.diag_embed(rho[0] + rho[1])
         + reg[:, None, None] * eye)
    solve2 = _make_solver(K, opts.chol, True)

    x = x0
    for _ in range(opts.polish):
        c = signed_slacks(x, _mv(A, x))
        h = tuple(torch.clamp_min(mu - r * ci, 0.0)
                  for mu, r, ci in zip(m, rho, c))
        grad = _mv(Hs, x) + gs - (h[0] - h[1]) - _rmv(A, h[2] - h[3])
        dx = solve2(-grad)
        dx = torch.where(_bc(_all_finite(dx), dx), dx, 0.0)
        x = x + dx
        c_new = signed_slacks(x, _mv(A, x))
        m = tuple(torch.clamp_min(mu - r * ci, 0.0)
                  for mu, r, ci in zip(m, rho, c_new))
    y_p = _mv(A, x)
    polished = (x,
                torch.where(mbl, torch.clamp_min(x - lb_s, 0.0), 1.0),
                torch.where(mbu, torch.clamp_min(ub_s - x, 0.0), 1.0),
                torch.where(mrl, torch.clamp_min(y_p - lbA_s, 0.0), 1.0),
                torch.where(mru, torch.clamp_min(ubA_s - y_p, 0.0), 1.0),
                *m)
    better = (score_of(polished) < score_of(state)) & _all_finite(x)
    return _where(better, polished, state)


def _refine_restart(H, g, A, lb, ub, lbA, ubA, opts, x0, warm):
    """The solve plus ``refine_restart`` delta-form rounds about its
    iterate, with compensated residual data; a round is kept per instance
    only if it improves an exact-penalty merit."""
    o1 = dataclasses.replace(opts, refine_restart=0)
    res = solve_qp(H, g, A, lb, ub, lbA, ubA, o1, x0=x0, warm=warm)
    o2 = dataclasses.replace(
        opts, refine_restart=0, var_scale=True, comp_resid=opts.refine_comp,
        max_iters=opts.refine_iters, polish=0, warm_duals="reuse",
        warm_floor=1e-7)
    zero_m = torch.zeros_like(lbA)
    W = _amax(g.abs()) + 1.0
    for _ in range(int(opts.refine_restart)):
        xb = res.x
        g_hi, g_lo = residual_affine(H, xb, g)
        gd = g_hi + g_lo
        y_hi, y_lo = residual_affine(A, xb, zero_m)
        lbAd = (lbA - y_hi) - y_lo
        ubAd = (ubA - y_hi) - y_lo
        # the delta problem's optimal duals equal the original's: warm-start
        # them (primal dx = 0)
        warm2 = dataclasses.replace(res, x=torch.zeros_like(xb))
        lbd, ubd = lb - xb, ub - xb
        res2 = solve_qp(H, gd, A, lbd, ubd, lbAd, ubAd, o2, warm=warm2)
        dx = res2.x
        Adx = _mv(A, dx)

        def _viol(db, dr):
            vb = torch.clamp_min(torch.maximum(lbd - db, db - ubd), 0.0)
            vr = torch.clamp_min(torch.maximum(lbAd - dr, dr - ubAd), 0.0)
            return torch.maximum(
                _amax(torch.where(torch.isfinite(vb), vb, 0.0)),
                _amax(torch.where(torch.isfinite(vr), vr, 0.0)))

        df = _bsum(gd * dx) + 0.5 * _bsum(dx * _mv(H, dx))
        dmerit = df + W * (_viol(dx, Adx) - _viol(torch.zeros_like(dx),
                                                  torch.zeros_like(Adx)))
        # 1e-3 * W: three orders below the objective rise of a diverged
        # round (see the JAX solver)
        ok = _all_finite(dx) & (dmerit <= 1e-3 * W)
        pick = lambda a, b: _where(ok, a, b)
        x = pick(xb + dx, xb)
        res = IpmResult(
            x=x, z_bounds=pick(res2.z_bounds, res.z_bounds),
            z_rows=pick(res2.z_rows, res.z_rows),
            iterations=res.iterations + res2.iterations,
            mu=pick(res2.mu, res.mu),
            primal_res=pick(res2.primal_res, res.primal_res),
            dual_res=pick(res2.dual_res, res.dual_res),
            objective=_objective(H, g, x))
    return res


@_highest_precision
def solve_qp(H, g, A, lb, ub, lbA, ubA, opts: IpmOptions = IpmOptions(),
             x0=None, warm: IpmResult | None = None) -> IpmResult:
    """Solve a batch of dense QPs.

    Shapes: H (B, n, n), g (B, n), A (B, m, n), lb/ub (B, n),
    lbA/ubA (B, m).  Infinite entries in lb/ub/lbA/ubA deactivate that
    side.  ``warm``: the :class:`IpmResult` of a previous same-shape batch;
    primal and duals are re-seeded from it.  On a CUDA device under
    ``chol="auto"``, a problem the kernels cannot run (not float32, n above
    ``kernels.chol.MAX_N``) raises ``ValueError`` before any launch.
    """
    _chol_fns(opts.chol)            # an unknown or unported choice raises
    kchol.check_entry(H.device, H.dtype, H.shape[-1], opts.chol)
    if opts.refine_restart:
        return _refine_restart(H, g, A, lb, ub, lbA, ubA, opts, x0, warm)

    if opts.var_scale:
        # per-variable symmetric power-of-two equilibration: transform,
        # solve with the option cleared, untransform.  The relative floor
        # keeps variables with no curvature and ~zero gradient (delta-form
        # slack columns) bounded.
        dH = _diag(H)
        vs = _pow2(torch.rsqrt(torch.maximum(
            torch.maximum(dH, g.abs()), (1e-9 * _amax(dH) + 1e-12)[:, None])))
        inner = dataclasses.replace(opts, var_scale=False)
        warm_i = None
        if warm is not None:
            warm_i = dataclasses.replace(warm, x=warm.x / vs,
                                         z_bounds=warm.z_bounds * vs)
        res = solve_qp(H * vs[:, :, None] * vs[:, None, :], g * vs,
                       A * vs[:, None, :], lb / vs, ub / vs, lbA, ubA, inner,
                       x0=None if x0 is None else x0 / vs, warm=warm_i)
        x_u = res.x * vs
        return dataclasses.replace(res, x=x_u, z_bounds=res.z_bounds / vs,
                                   objective=_objective(H, g, x_u))
    return _solve_core(H, g, A, lb, ub, lbA, ubA, opts, x0, warm)


def _solve_core(H, g, A, lb, ub, lbA, ubA, opts, x0, warm) -> IpmResult:
    """One plain dense IPM solve (no restart, no variable scaling)."""
    Bsz, m, n = A.shape
    dtype, dev = H.dtype, H.device
    inf = float("inf")

    # ---- objective scaling (keeps 1e8 soft costs f32-safe) ----------------
    gmax = torch.maximum(_amax(g.abs()), _amax(H.abs()))
    c_scale = _pow2(1.0 / torch.clamp_min(gmax, 1.0))            # (B,)
    c1 = c_scale[:, None]
    Hs = H * c_scale[:, None, None]
    gs = g * c1

    # ---- row equilibration (unit inf-norm general rows) -------------------
    if opts.equilibrate:
        r_scale = _pow2(1.0 / torch.clamp_min(A.abs().amax(-1), 1e-12))
        A = A * r_scale[:, :, None]
        lbA = lbA * r_scale
        ubA = ubA * r_scale
    else:
        r_scale = torch.ones((Bsz, m), dtype=dtype, device=dev)

    # ---- masks and safe bound values --------------------------------------
    mbl, lb_s = _side(lb)
    mbu, ub_s = _side(ub)
    mrl, lbA_s = _side(lbA)
    mru, ubA_s = _side(ubA)
    masks = (mbl, mbu, mrl, mru)
    n_active = sum(_bsum(mk.to(torch.int64)) for mk in masks)
    n_active = torch.clamp_min(n_active, 1).to(dtype)             # (B,)
    eye = torch.eye(n, dtype=dtype, device=dev)
    hdiag = 1.0 + _amax(_diag(Hs).abs())                           # (B,)

    def make_kkt_solver(K):
        return _make_solver(K, opts.chol, opts.scale_kkt)

    use_centered = (opts.init == "centered" and warm is None and x0 is None)
    if warm is not None and x0 is None:
        x0 = warm.x
    if use_centered:
        # regularised unconstrained minimiser, projected into the box
        shift0 = 1e-3 if torch.finfo(dtype).eps > 1e-10 else 1e-8
        K0 = Hs + (shift0 * hdiag)[:, None, None] * eye
        x0 = make_kkt_solver(K0)(-gs)
        x0 = torch.where(_bc(_all_finite(x0), x0), x0, 0.0)
        x0 = torch.minimum(torch.maximum(x0, torch.where(mbl, lb_s, -inf)),
                           torch.where(mbu, ub_s, inf))
    if x0 is None:
        x0 = torch.zeros((Bsz, n), dtype=dtype, device=dev)

    s_floor = opts.s_init if warm is None else opts.warm_floor
    z_floor = opts.z_init if warm is None else opts.warm_floor
    y0 = _mv(A, x0)

    if warm is not None and opts.warm_duals == "centered":
        use_centered = True          # reuse the centered slack/dual placement
    if use_centered:
        # Mehrotra-style shift: every slack positive by a common offset,
        # duals on the central path (s_i z_i = mu0)
        raw = [torch.where(mbl, x0 - lb_s, inf),
               torch.where(mbu, ub_s - x0, inf),
               torch.where(mrl, y0 - lbA_s, inf),
               torch.where(mru, ubA_s - y0, inf)]
        smin = torch.minimum(torch.minimum(_amin(raw[0]), _amin(raw[1])),
                             torch.minimum(_amin(raw[2]), _amin(raw[3])))
        shift = (torch.clamp_min(-1.5 * smin, 0.0) + 1e-2)[:, None]
        S0 = tuple(torch.where(mk, rw + shift, 1.0)
                   for mk, rw in zip(masks, raw))
        mu0 = opts.mu0 if warm is None else opts.warm_mu0
        Z0 = tuple(torch.where(mk, mu0 / s_, 0.0)
                   for mk, s_ in zip(masks, S0))
    else:
        def slacks_init(y, lo, hi, ml, mu_):
            return (torch.where(ml, torch.clamp_min(y - lo, s_floor), 1.0),
                    torch.where(mu_, torch.clamp_min(hi - y, s_floor), 1.0))

        S0 = (slacks_init(x0, lb_s, ub_s, mbl, mbu)
              + slacks_init(y0, lbA_s, ubA_s, mrl, mru))
        if warm is None:
            Z0 = tuple(mk.to(dtype) * opts.z_init for mk in masks)
        else:
            # previous duals are for the unscaled, unequilibrated problem
            wzb = warm.z_bounds * c1
            wzr = warm.z_rows * c1 / r_scale
            Z0 = tuple(torch.where(mk, torch.clamp_min(w, z_floor), 0.0)
                       for mk, w in [(mbl, wzb), (mbu, -wzb), (mrl, wzr),
                                     (mru, -wzr)])

    def mu_of(state):
        tot = sum(_bsum(torch.where(mk, s_ * z_, 0.0))
                  for mk, s_, z_ in zip(masks, state[1:5], state[5:9]))
        return tot / n_active

    if opts.comp_resid:
        A_Tn = -A.mT                 # once per solve

    def residuals(state):
        x, sbl, sbu, srl, sru, zbl, zbu, zrl, zru = state
        y = _mv(A, x)
        if opts.comp_resid:
            h1, l1 = residual_affine(Hs, x, gs - (zbl - zbu))
            h2, l2 = residual_affine(A_Tn, zrl - zru, h1)
            r_dual = h2 + (l2 + l1)
        else:
            r_dual = _mv(Hs, x) + gs - (zbl - zbu) - _rmv(A, zrl - zru)
        r_pbl = torch.where(mbl, sbl - (x - lb_s), 0.0)
        r_pbu = torch.where(mbu, sbu - (ub_s - x), 0.0)
        r_prl = torch.where(mrl, srl - (y - lbA_s), 0.0)
        r_pru = torch.where(mru, sru - (ubA_s - y), 0.0)
        return r_dual, r_pbl, r_pbu, r_prl, r_pru

    def pres_of(r_pbl, r_pbu, r_prl, r_pru):
        """Primal residual in ORIGINAL row units."""
        return torch.maximum(
            torch.maximum(_amax(r_pbl.abs()), _amax(r_pbu.abs())),
            torch.maximum(_amax((r_prl / r_scale).abs()),
                          _amax((r_pru / r_scale).abs())))

    def score_fn(pres, dres, mu):
        """Best-iterate ranking score; with ``comp_resid`` lexicographic:
        among converged-ish states rank by the (accurate) dual residual."""
        base = pres + 10.0 * dres + mu
        if not opts.comp_resid:
            return base
        ok = (pres < 1e-4) & (mu < 1e-6)
        return torch.where(ok, dres, 1e3 + base)

    def score_of(state):
        r_dual, *rp = residuals(state)
        return score_fn(pres_of(*rp), _amax(r_dual.abs()), mu_of(state))

    def converged(state):
        r_dual, *rp = residuals(state)
        return ((pres_of(*rp) < opts.tol) & (_amax(r_dual.abs()) < opts.tol)
                & (mu_of(state) < opts.tol))

    d_cap = D_CAP_F64 if torch.finfo(dtype).eps < 1e-10 else D_CAP_F32

    def max_step(s, ds, mask):
        """Largest alpha in (0, 1] keeping s + alpha ds >= (1-tau) s."""
        lim = torch.where(mask & (ds < 0),
                          -opts.tau * s / torch.clamp_max(ds, -1e-30), 1.0)
        return torch.clamp_max(_amin(lim), 1.0)

    def iterate(state, regm):
        x = state[0]
        S, Z = state[1:5], state[5:9]
        sbl, sbu, srl, sru = S
        zbl, zbu, zrl, zru = Z
        mu = mu_of(state)
        r_dual, r_pbl, r_pbu, r_prl, r_pru = residuals(state)
        pres_in = pres_of(r_pbl, r_pbu, r_prl, r_pru)
        dres_in = _amax(r_dual.abs())
        score_in = score_fn(pres_in, dres_in, mu)

        if opts.freeze is not None:
            fp, fd, fm = opts.freeze
            frozen = (pres_in < fp) & (dres_in < fd) & (mu < fm)
        else:
            frozen = torch.zeros((Bsz,), dtype=torch.bool, device=dev)

        dgs = [torch.clamp(torch.where(mk, z_ / s_, 0.0), 0.0, d_cap)
               for mk, z_, s_ in zip(masks, Z, S)]
        D_b = dgs[0] + dgs[1]
        D_r = dgs[2] + dgs[3]
        K = Hs + _qf(A, D_r) + torch.diag_embed(D_b)
        # static regularisation relative to the Hessian scale; ``regm``
        # grows 100x after each breakdown (non-finite iterate)
        K = K + (opts.reg * regm * hdiag)[:, None, None] * eye
        ksolve = make_kkt_solver(K)

        def kkt_solve(rc_bl, rc_bu, rc_rl, rc_ru):
            t_b = (torch.where(mbl, (rc_bl + zbl * r_pbl) / sbl, 0.0)
                   - torch.where(mbu, (rc_bu + zbu * r_pbu) / sbu, 0.0))
            t_r = (torch.where(mrl, (rc_rl + zrl * r_prl) / srl, 0.0)
                   - torch.where(mru, (rc_ru + zru * r_pru) / sru, 0.0))
            dx = ksolve(-r_dual + t_b + _rmv(A, t_r))
            dy = _mv(A, dx)
            ds = (torch.where(mbl, dx - r_pbl, 0.0),
                  torch.where(mbu, -dx - r_pbu, 0.0),
                  torch.where(mrl, dy - r_prl, 0.0),
                  torch.where(mru, -dy - r_pru, 0.0))
            dz = tuple(torch.where(mk, (rc_ - z_ * ds_) / s_, 0.0)
                       for mk, rc_, z_, ds_, s_ in zip(
                           masks, (rc_bl, rc_bu, rc_rl, rc_ru), Z, ds, S))
            return dx, ds, dz

        def steps_of(ds, dz):
            a_p = torch.minimum(
                torch.minimum(max_step(sbl, ds[0], mbl),
                              max_step(sbu, ds[1], mbu)),
                torch.minimum(max_step(srl, ds[2], mrl),
                              max_step(sru, ds[3], mru)))
            a_d = torch.minimum(
                torch.minimum(max_step(zbl, dz[0], mbl),
                              max_step(zbu, dz[1], mbu)),
                torch.minimum(max_step(zrl, dz[2], mrl),
                              max_step(zru, dz[3], mru)))
            return a_p, a_d

        # ---- predictor (affine) step --------------------------------------
        rc_a = tuple(torch.where(mk, -s_ * z_, 0.0)
                     for mk, s_, z_ in zip(masks, S, Z))
        _, ds_a, dz_a = kkt_solve(*rc_a)
        a_p, a_d = steps_of(ds_a, dz_a)
        ap1, ad1 = a_p[:, None], a_d[:, None]
        mu_aff = sum(_bsum(torch.where(mk, (s_ + ap1 * ds_)
                                       * (z_ + ad1 * dz_), 0.0))
                     for mk, s_, ds_, z_, dz_ in zip(masks, S, ds_a, Z, dz_a)
                     ) / n_active
        sigma = torch.clamp((mu_aff / torch.clamp_min(mu, 1e-300)) ** 3,
                            0.0, 1.0)

        # ---- corrector step -----------------------------------------------
        mu_t = sigma * mu
        rc_c = tuple(torch.where(mk, mu_t[:, None] - s_ * z_ - ds_ * dz_,
                                 0.0)
                     for mk, s_, z_, ds_, dz_ in zip(masks, S, Z, ds_a, dz_a))
        dx, ds, dz = kkt_solve(*rc_c)
        a_p, a_d = steps_of(ds, dz)

        # ---- Gondzio centrality correctors (same factorisation) -----------
        lo_t, hi_t = (0.1 * mu_t)[:, None], (10.0 * mu_t)[:, None]
        for _ in range(opts.correctors):
            ap_t = torch.clamp_max(a_p + 0.1, 1.0)[:, None]
            ad_t = torch.clamp_max(a_d + 0.1, 1.0)[:, None]
            rc_g = []
            for s_, z_, ds_, dz_, mk, rc_ in zip(S, Z, ds, dz, masks, rc_c):
                comp = (s_ + ap_t * ds_) * (z_ + ad_t * dz_)
                target = torch.minimum(torch.maximum(comp, lo_t), hi_t)
                rc_g.append(torch.where(mk, rc_ + (target - comp), 0.0))
            dx2, ds2, dz2 = kkt_solve(*rc_g)
            a_p2, a_d2 = steps_of(ds2, dz2)
            better = (a_p2 >= a_p) & (a_d2 >= a_d)
            dx, ds, dz = _where(better, (dx2, ds2, dz2), (dx, ds, dz))
            a_p = torch.where(better, a_p2, a_p)
            a_d = torch.where(better, a_d2, a_d)

        ap1, ad1 = a_p[:, None], a_d[:, None]
        new = ((x + ap1 * dx,)
               + tuple(torch.where(mk, s_ + ap1 * ds_, 1.0)
                       for mk, s_, ds_ in zip(masks, S, ds))
               + tuple(torch.where(mk, z_ + ad1 * dz_, 0.0)
                       for mk, z_, dz_ in zip(masks, Z, dz)))
        # NaN rejection + convergence freeze, per instance
        finite = torch.stack([_all_finite(v) for v in new]).all(0)
        good = finite & torch.logical_not(frozen)
        return _where(good, new, state), good, score_in

    def regm_next(regm, good):
        # breakdown -> escalate 100x; success -> decay back toward 1
        return torch.where(good, torch.clamp_min(regm * 0.1, 1.0),
                           torch.clamp_max(regm * 100.0, 1e12))

    state = (x0,) + tuple(S0) + tuple(Z0)
    best = state
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
            better = active & (sc < bscore)
            best = _where(better, state, best)
            bscore = torch.where(better, sc, bscore)
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

    # the best iterate seen (f32 trajectories can degrade after convergence)
    state = _where(score_of(state) < bscore, state, best)

    if opts.polish > 0:
        state = _polish(state, Hs, gs, A, lb_s, ub_s, lbA_s, ubA_s, masks,
                        opts, score_of)

    x = state[0]
    r_dual, *rp = residuals(state)
    return IpmResult(
        x=x,
        z_bounds=(state[5] - state[6]) / c1,
        z_rows=(state[7] - state[8]) * r_scale / c1,
        iterations=iters,
        mu=mu_of(state) / c_scale,
        primal_res=pres_of(*rp),
        dual_res=_amax(r_dual.abs()) / c_scale,
        objective=_objective(H, g, x))
