"""The closed loop's plant and geometry: PyTorch port against the JAX
package, part by part, in f64 on the CPU.

Track queries (position, tangent, angle, curvature, its derivative, the
Newton projection) at random s and points on fsg2019; the frame
transforms and ``angdiff``, across the +-pi wrap and past s = L; a PID
sequence; ten RK6 substeps of the Cartesian plant, whose tableau keeps the
reference's k5 quirk; the curvilinear and Cartesian kinematic models; the
RK2 kinematic linearisation (Ad, Bd, dd) along a horizon.  Inputs are
made with numpy from a seed and handed to both packages.

Tolerance: the same f64 expressions in another evaluation order differ
by ~1e-16 relative per operation.  Elementwise quantities are held to
1e-12 relative (and 1e-12 absolute near zero); the projection's twelve
Newton steps, ten plant substeps and the Jacobians to 1e-10.  The quirk
check asks for a gap ~1e3 times wider than that between the reference
tableau and the textbook one.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fsae_mpc_tpu import config as jconfig
from fsae_mpc_tpu.models import cartesian as jcart
from fsae_mpc_tpu.models import curvilinear as jcm
from fsae_mpc_tpu.models import integrators as jint
from fsae_mpc_tpu.models import pid as jpid
from fsae_mpc_tpu.models import transforms as jtr
from fsae_mpc_tpu.track import load_track as jload_track

from fsae_mpc_tpu_torch.config import (STEER_PID, VEL_PID, PidParams,
                                       VehicleParams)
from fsae_mpc_tpu_torch.models import cartesian as cart
from fsae_mpc_tpu_torch.models import curvilinear as cm
from fsae_mpc_tpu_torch.models import integrators
from fsae_mpc_tpu_torch.models import pid
from fsae_mpc_tpu_torch.models import transforms as tr
from fsae_mpc_tpu_torch.track import load_track


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


F64 = torch.float64
TIGHT = dict(rtol=1e-12, atol=1e-12)
LOOSE = dict(rtol=1e-10, atol=1e-10)
P = VehicleParams()
PJ = jconfig.VehicleParams()


@pytest.fixture(scope="module")
def tracks():
    tj, _ = jload_track("data/fsg2019.csv", dtype=jnp.float64)
    tp, _ = load_track("data/fsg2019.csv", dtype=F64, device="cpu")
    return tj, tp


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=F64)


def _close(got, ref, tol=TIGHT, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), **tol,
                               err_msg=msg)


def test_track_queries(tracks):
    tj, tp = tracks
    L = float(tj.L)
    rng = np.random.default_rng(0)
    s = np.concatenate([rng.uniform(-0.5 * L, 1.5 * L, 64), [0.0, L]])
    queries = ("position", "tangent", "angle", "curvature", "curvature_d")
    refs = jax.jit(lambda s: [getattr(tj, q)(s) for q in queries])(s)
    for q, ref in zip(queries, refs):
        got = getattr(tp, q)(_t(s))
        for a, b in (zip(got, ref) if isinstance(got, tuple)
                     else [(got, ref)]):
            _close(a, b, msg=q)
    # the projection of points up to 1 m off the centreline, warm-started
    # up to 2 m away along it
    s0 = rng.uniform(0.0, L, 32)
    cx, cy = tj.position(s0)
    tx, ty = tj.tangent(s0)
    off = rng.uniform(-1.0, 1.0, 32) / np.hypot(tx, ty)
    x, y = np.asarray(cx - off * ty), np.asarray(cy + off * tx)
    s_init = s0 + rng.uniform(-2.0, 2.0, 32)
    got = tp.closest_point(_t(x), _t(y), _t(s_init))
    ref = tj.closest_point(jnp.asarray(x), jnp.asarray(y),
                           jnp.asarray(s_init))
    _close(got, ref, LOOSE, "closest_point")
    _close(got, s0, dict(rtol=0, atol=1e-6), "closest_point vs s0")


def test_transforms_and_angdiff(tracks):
    tj, tp = tracks
    L = float(tj.L)
    rng = np.random.default_rng(1)
    a = rng.uniform(-4.0, 4.0, 64)
    b = np.concatenate([a[:32] + rng.uniform(-7.0, 7.0, 32),
                        a[32:] + np.pi + rng.uniform(-1e-9, 1e-9, 32)])
    d = tr.angdiff(_t(a), _t(b))
    _close(d, jtr.angdiff(a, b), msg="angdiff")
    assert bool((d >= -np.pi).all() and (d < np.pi).all())
    # curvilinear -> Cartesian, s past L and below 0, then back
    s = np.concatenate([rng.uniform(0.0, L, 24), L + rng.uniform(0, 5, 4),
                        -rng.uniform(0, 5, 4)])
    n = rng.uniform(-0.7, 0.7, 32)
    mu = rng.uniform(-3.0, 3.0, 32)
    got = tr.curvilinear_to_cartesian(_t(s), _t(n), _t(mu), tp)
    ref = jtr.curvilinear_to_cartesian(s, n, mu, tj)
    for g, r in zip(got, ref):
        _close(g, r, msg="curvilinear_to_cartesian")
    s_init = s + rng.uniform(-1.0, 1.0, 32)
    back = tr.cartesian_to_curvilinear(*got, tp, _t(s_init))
    ref = jtr.cartesian_to_curvilinear(*[jnp.asarray(np.asarray(g))
                                         for g in got], tj,
                                       jnp.asarray(s_init))
    for g, r in zip(back, ref):
        _close(g, r, LOOSE, "cartesian_to_curvilinear")
    _close(back[1], n, dict(rtol=0, atol=1e-8), "n round trip")
    _close(tr.angdiff(back[2], _t(mu)), np.zeros(32),
           dict(rtol=0, atol=1e-8), "mu round trip")


def test_pid_sequence():
    rng = np.random.default_rng(2)
    pids = [VEL_PID, STEER_PID, PidParams(kp=2.0, ki=0.5, kd=1.5,
                                          max_output=3.0)]
    targets = rng.uniform(-5.0, 5.0, (20, 8))
    currents = rng.uniform(-5.0, 5.0, (20, 8))
    for p in pids:
        pj = jconfig.PidParams(**dataclasses.asdict(p))
        st = pid.pid_init(_t(np.zeros(8)))
        sj = jpid.pid_init(jnp.zeros(8))
        for k in range(20):
            out, st = pid.pid_step(_t(targets[k]), _t(currents[k]), p, st)
            oj, sj = jpid.pid_step(targets[k], currents[k], pj, sj)
            _close(out, oj, msg=f"{p} step {k}")
            for a, b in zip(st, sj):
                _close(a, b, msg=f"{p} state {k}")


def _plant_states(rng, n):
    x = np.zeros((n, 7))
    x[:, :3] = rng.uniform(-5.0, 5.0, (n, 3))
    x[:, 3] = rng.uniform(0.5, 20.0, n)
    x[:, 4] = rng.uniform(-0.5, 0.5, n)
    x[:, 5] = rng.uniform(-1.0, 1.0, n)
    x[:, 6] = rng.uniform(-0.3, 0.3, n)
    u = np.stack([rng.uniform(-2800.0, 2800.0, n),
                  rng.uniform(-0.8, 0.8, n)], -1)
    return x, u


def test_rk6_plant_substeps():
    """Ten RK6 substeps of the Cartesian plant under PID-sized inputs, on a
    batch of states; the tableau is the reference's, quirk included."""
    rng = np.random.default_rng(3)
    x, u = _plant_states(rng, 16)
    f = lambda xx, uu: cart.f_cart_dyn(xx, uu, P)
    fj = jax.jit(jax.vmap(lambda xx, uu: jint.rk6_step(
        lambda a, b: jcart.f_cart_dyn(a, b, PJ), xx, uu, 0.005)))
    xp, xj = _t(x), jnp.asarray(x)
    for _ in range(10):
        xp = integrators.rk6_step(f, xp, _t(u), 0.005)
        xj = fj(xj, jnp.asarray(u))
    _close(xp, xj, LOOSE, "rk6 substeps")
    _close(cart.integrate_cart_dyn(_t(x), _t(u), 0.05, P),
           jax.vmap(lambda a, b: jcart.integrate_cart_dyn(a, b, 0.05, PJ))(
               x, u), LOOSE, "integrate_cart_dyn")
    assert integrators.STEPPERS["rk6"] is integrators.rk6_step

    # the k5 stage reads k2 twice; a textbook 7/27 k2 + 10/27 k3 moves
    # the step far beyond the tolerance
    def textbook(f, x, u, dt):
        k1 = f(x, u)
        k2 = f(x + k1 * dt / 2.0, u)
        k3 = f(x + k1 * dt / 4.0 + k2 * dt / 8.0, u)
        k4 = f(x - k2 * dt + 2.0 * k3 * dt, u)
        k5 = f(x + (7.0 / 27.0) * k2 * dt + (10.0 / 27.0) * k3 * dt
               + k4 * dt / 27.0, u)
        k6 = f(x + (28.0 / 625.0) * k1 * dt - k2 * dt / 5.0
               + (546.0 / 625.0) * k3 * dt + (54.0 / 625.0) * k4 * dt
               - (378.0 / 625.0) * k5 * dt, u)
        return x + dt * (k1 / 24.0 + 5.0 / 48.0 * k4 + 27.0 / 56.0 * k5
                         + 125.0 / 336.0 * k6)

    gap = (integrators.rk6_step(f, _t(x), _t(u), 0.05)
           - textbook(f, _t(x), _t(u), 0.05)).abs().max()
    assert float(gap) > 1e-7


def test_kinematic_models(tracks):
    tj, tp = tracks
    rng = np.random.default_rng(4)
    xc = np.stack([rng.uniform(0.0, float(tj.L), 16),
                   rng.uniform(-0.7, 0.7, 16), rng.uniform(-0.3, 0.3, 16),
                   rng.uniform(0.5, 20.0, 16), rng.uniform(-0.4, 0.4, 16)],
                  -1)
    u = np.stack([rng.uniform(-10.0, 10.0, 16),
                  rng.uniform(-0.4, 0.4, 16)], -1)
    for b in range(4):
        _close(cm.f_curv_kin(_t(xc[b]), _t(u[b]), tp, P),
               jcm.f_curv_kin(xc[b], u[b], tj, PJ), msg="f_curv_kin")
        _close(cm.curvilinear_kinematic_bicycle(_t(xc[b]), _t(u[b]), 0.05,
                                                tp, P),
               jcm.curvilinear_kinematic_bicycle(xc[b], u[b], 0.05, tj, PJ),
               msg="curvilinear_kinematic_bicycle")
    # the Cartesian kinematic bicycle: batched rollout of 6 controls
    xk = xc.copy()
    xk[:, 2] = rng.uniform(-3.0, 3.0, 16)
    us = rng.uniform(-0.4, 0.4, (16, 6, 2))
    _close(cart.f_cart_kin(_t(xk), _t(u), P),
           jax.vmap(lambda a, b: jcart.f_cart_kin(a, b, PJ))(xk, u),
           msg="f_cart_kin")
    _close(cart.kinematic_bicycle_horizon(_t(xk), _t(us), 0.05, P),
           jax.vmap(lambda a, b: jcart.kinematic_bicycle_horizon(
               a, b, 0.05, PJ))(xk, us), LOOSE, "kinematic_bicycle_horizon")


def test_rk2_kinematic_linearisation(tracks):
    """(Ad, Bd, dd) of the kinematic controller's RK2 step along a batch of
    horizons; the curvature enters at a detached s, as in the reference."""
    tj, tp = tracks
    rng = np.random.default_rng(5)
    N = 6
    x = np.stack([rng.uniform(0.0, float(tj.L), (2, N)),
                  rng.uniform(-0.5, 0.5, (2, N)),
                  rng.uniform(-0.2, 0.2, (2, N)),
                  rng.uniform(1.0, 15.0, (2, N)),
                  rng.uniform(-0.3, 0.3, (2, N))], -1)
    u = rng.uniform(-0.4, 0.4, (2, N, 2))
    step = lambda a, b: integrators.rk2_step(
        lambda xx, uu: cm.f_curv_kin(xx, uu, tp, P), a, b, 0.05)
    step_j = lambda a, b: jint.rk2_step(
        lambda xx, uu: jcm.f_curv_kin(xx, uu, tj, PJ), a, b, 0.05)
    got = integrators.linearize_discrete(step, _t(x), _t(u))
    ref = jax.jit(jax.vmap(lambda a, b: jint.linearize_discrete(
        step_j, a, b)))(x, u)
    for name, g, r in zip(("Ad", "Bd", "dd"), got, ref):
        _close(g, r, LOOSE, name)
