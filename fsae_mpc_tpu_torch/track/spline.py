"""Cubic Bezier spline fitting (host numpy, float64) and evaluation (torch).

Port of ``fsae_mpc_tpu.track.spline``.  The fit and the arclength
reparametrisation run once per track on the host in float64 and are the
JAX package's numpy code unchanged; the evaluation runs on tensors and is
written so that ``torch.func.vmap``/``jacfwd`` can trace it (the segment
gather uses ``index_select``, which vmap can batch; a 0-d integer index
would need ``.item()``).  A batch of tracks (``P`` (B, M, 4), ``dl``
(B,)) is evaluated elementwise: query points (B, ...) each on their own
instance's spline.
"""

from __future__ import annotations

import numpy as np
import torch


# ---------------------------------------------------------------------------
# Host-side fitting (numpy, float64)
# ---------------------------------------------------------------------------

def make_spline(points: np.ndarray) -> np.ndarray:
    """Fit an open C2 cubic Bezier spline through ``points``.

    Returns coefficients ``P`` of shape ``(N, 4)`` = [P0, P1, P2, P3] per
    segment.
    """
    P = np.asarray(points, dtype=np.float64).reshape(-1)
    N = len(P) - 1
    if N < 2:
        raise ValueError("need at least 3 points for an open spline")

    A = np.zeros((N, N))
    idx = np.arange(N)
    A[idx, idx] = 4.0
    A[idx[:-1], idx[:-1] + 1] = 1.0
    A[idx[1:], idx[1:] - 1] = 1.0
    A[0, 0] = 2.0
    A[N - 1, N - 2] = 2.0
    A[N - 1, N - 1] = 7.0

    b = np.empty(N)
    b[0] = P[0] + 2.0 * P[1]
    b[1:N - 1] = 4.0 * P[1:N - 1] + 2.0 * P[2:N]
    b[N - 1] = 8.0 * P[N - 1] + P[N]

    P1 = np.linalg.solve(A, b)

    P2 = np.empty(N)
    P2[0] = 2.0 * P1[0] - P[0]
    P2[1:N - 1] = 2.0 * P[2:N] - P1[2:N]
    P2[N - 1] = (P[N] + P1[N - 1]) / 2.0

    return np.stack([P[:N], P1, P2, P[1:N + 1]], axis=1)


def make_spline_periodic(points: np.ndarray) -> np.ndarray:
    """Fit a closed (periodic) C2 cubic Bezier spline through ``points``
    (which must NOT repeat the first point at the end)."""
    P = np.asarray(points, dtype=np.float64).reshape(-1)
    N = len(P)
    if N < 3:
        raise ValueError("need at least 3 points for a periodic spline")

    A = np.zeros((N, N))
    idx = np.arange(N)
    A[idx, idx] = 4.0
    A[idx, (idx + 1) % N] = 1.0
    A[idx, (idx - 1) % N] = 1.0

    b = 4.0 * P + 2.0 * np.roll(P, -1)

    P1 = np.linalg.solve(A, b)
    P2 = 2.0 * np.roll(P, -1) - np.roll(P1, -1)

    return np.stack([P, P1, P2, np.roll(P, -1)], axis=1)


# 32-point Gauss-Legendre nodes/weights on [0, 1]
_GL_X, _GL_W = np.polynomial.legendre.leggauss(32)
_GL_X = (_GL_X + 1.0) / 2.0
_GL_W = _GL_W / 2.0


def _np_bezier_d(t: np.ndarray, seg: np.ndarray) -> np.ndarray:
    """Derivative of one Bezier segment (numpy, unit parameter)."""
    p0, p1, p2, p3 = seg
    return (-3.0 * (1.0 - t) ** 2 * p0
            + 3.0 * (3.0 * t ** 2 - 4.0 * t + 1.0) * p1
            + 3.0 * (2.0 * t - 3.0 * t ** 2) * p2
            + 3.0 * t ** 2 * p3)


def _segment_arclength(xseg: np.ndarray, yseg: np.ndarray,
                       upper: float = 1.0) -> float:
    """Arclength of a Bezier segment over [0, upper] via fixed-order GL."""
    t = _GL_X * upper
    speed = np.hypot(_np_bezier_d(t, xseg), _np_bezier_d(t, yseg))
    return float(upper * np.dot(_GL_W, speed))


def _np_bezier(t: float, seg: np.ndarray) -> float:
    p0, p1, p2, p3 = seg
    return (p0 * (1 - t) ** 3 + 3 * p1 * (1 - t) ** 2 * t
            + 3 * p2 * (1 - t) * t ** 2 + p3 * t ** 3)


def arclength_reparam(x_P: np.ndarray, y_P: np.ndarray, M: int,
                      periodic: bool, n_bisect: int = 48):
    """Reparametrise a fitted spline by arclength: per-segment arclengths,
    M+1 evenly spaced points found by fixed-iteration bisection, refit.
    Returns ``(x_P_new, y_P_new, dl, L)``."""
    x_P = np.asarray(x_P, dtype=np.float64)
    y_P = np.asarray(y_P, dtype=np.float64)
    N = x_P.shape[0]

    seg_len = np.array([_segment_arclength(x_P[i], y_P[i]) for i in range(N)])
    l_cum = np.concatenate([[0.0], np.cumsum(seg_len)])
    L = float(l_cum[-1])
    dl = L / M

    Px = np.empty(M + 1)
    Py = np.empty(M + 1)
    Px[0], Py[0] = x_P[0, 0], y_P[0, 0]
    Px[M], Py[M] = x_P[N - 1, 3], y_P[N - 1, 3]

    for i in range(1, M):
        target = i * dl
        j = int(np.searchsorted(l_cum, target, side="left")) - 1
        j = min(max(j, 0), N - 1)
        residual_target = target - l_cum[j]
        lo, hi = 0.0, 1.0
        for _ in range(n_bisect):
            mid = 0.5 * (lo + hi)
            if _segment_arclength(x_P[j], y_P[j], mid) < residual_target:
                lo = mid
            else:
                hi = mid
        t_i = 0.5 * (lo + hi)
        Px[i] = _np_bezier(t_i, x_P[j])
        Py[i] = _np_bezier(t_i, y_P[j])

    if periodic:
        x_new = make_spline_periodic(Px[:M])
        y_new = make_spline_periodic(Py[:M])
    else:
        x_new = make_spline(Px)
        y_new = make_spline(Py)

    return x_new, y_new, dl, L


# ---------------------------------------------------------------------------
# Evaluation (torch, vectorised over query points)
# ---------------------------------------------------------------------------

def _per_point(dl, t):
    """``dl`` shaped to broadcast against query points ``t``: a batch of
    tracks' (B,) values against (B, ...) points; one track's 0-d value as
    it is."""
    if dl.ndim == 0:
        return dl
    return dl.reshape(dl.shape + (1,) * (t.ndim - 1))


def _locate(t, P, dl):
    """Wrap the query parameter ``mod(t, dl*M)`` and gather the segment
    ``i = floor(t/dl)`` coefficients; ``tau = t/dl - i``.  Returns
    ``(tau, coeffs, dl)``, ``dl`` broadcast against ``t``."""
    M = P.shape[-2]
    dl = _per_point(dl, t)
    t = torch.remainder(t, dl * M)
    i = torch.clamp(torch.floor(t / dl).to(torch.int64), 0, M - 1)
    tau = t / dl - i
    if P.ndim == 3:
        # instance b's row i of the (B*M, 4) stack of every instance's table
        first = M * torch.arange(P.shape[0], device=i.device)
        P, i = P.reshape(-1, P.shape[-1]), i + _per_point(first, i)
    coeffs = torch.index_select(P, 0, i.reshape(-1)).reshape(
        i.shape + (P.shape[-1],))
    return tau, coeffs, dl


def interpolate(t, P, dl):
    """Spline value."""
    tau, c, _ = _locate(t, P, dl)
    omt = 1.0 - tau
    return (c[..., 0] * omt ** 3 + 3.0 * c[..., 1] * omt ** 2 * tau
            + 3.0 * c[..., 2] * omt * tau ** 2 + c[..., 3] * tau ** 3)


def interpolate_d(t, P, dl):
    """First derivative d/ds."""
    tau, c, dl = _locate(t, P, dl)
    d = (-3.0 * (1.0 - tau) ** 2 * c[..., 0]
         + 3.0 * (3.0 * tau ** 2 - 4.0 * tau + 1.0) * c[..., 1]
         + 3.0 * (2.0 * tau - 3.0 * tau ** 2) * c[..., 2]
         + 3.0 * tau ** 2 * c[..., 3])
    return d / dl


def interpolate_dd(t, P, dl):
    """Second derivative."""
    tau, c, dl = _locate(t, P, dl)
    dd = (6.0 * (1.0 - tau) * c[..., 0] + 6.0 * (3.0 * tau - 2.0) * c[..., 1]
          + 6.0 * (1.0 - 3.0 * tau) * c[..., 2] + 6.0 * tau * c[..., 3])
    return dd / dl ** 2


def angle(s, x_P, y_P, dl):
    """Tangent angle theta(s)."""
    return torch.arctan2(interpolate_d(s, y_P, dl), interpolate_d(s, x_P, dl))


def curvature(s, x_P, y_P, dl):
    """Signed curvature kappa(s)."""
    x_d = interpolate_d(s, x_P, dl)
    y_d = interpolate_d(s, y_P, dl)
    x_dd = interpolate_dd(s, x_P, dl)
    y_dd = interpolate_dd(s, y_P, dl)
    return (x_d * y_dd - x_dd * y_d) / (x_d ** 2 + y_d ** 2) ** 1.5


def curvature_d(s, x_P, y_P, dl):
    """d kappa/ds by central difference with step ``dl``."""
    h = _per_point(dl, s)
    k_l = curvature(s - h, x_P, y_P, dl)
    k_u = curvature(s + h, x_P, y_P, dl)
    return (k_u - k_l) / (2.0 * h)


def closest_point(x0, y0, x_P, y_P, dl, s_init, num_iters: int = 12):
    """Project points onto the spline: a fixed number of Newton steps on
    the squared distance, warm-started at ``s_init`` (elementwise over
    ``x0``/``y0``/``s_init``).  A fixed count keeps the projection free of
    host synchronisation."""
    s = s_init * torch.ones_like(x0)
    for _ in range(num_iters):
        X = interpolate(s, x_P, dl)
        Y = interpolate(s, y_P, dl)
        X_d = interpolate_d(s, x_P, dl)
        Y_d = interpolate_d(s, y_P, dl)
        X_dd = interpolate_dd(s, x_P, dl)
        Y_dd = interpolate_dd(s, y_P, dl)
        dist_d = 2.0 * (X - x0) * X_d + 2.0 * (Y - y0) * Y_d
        dist_dd = (2.0 * (X - x0) * X_dd + 2.0 * X_d ** 2
                   + 2.0 * (Y - y0) * Y_dd + 2.0 * Y_d ** 2)
        guard = torch.where(dist_dd < 0, torch.full_like(dist_dd, -1e-9),
                            1e-9)
        denom = torch.where(torch.abs(dist_dd) < 1e-9, guard, dist_dd)
        s = s - dist_d / denom
    return s
