"""Divide-and-conquer condensing, the blocked Cholesky route, the spline's
third derivative and the native runtime: the PyTorch port against the JAX
package, in f64 on the CPU, inputs made with numpy from a seed.

  * ``condense_dnc`` at the JAX package's four shapes of
    ``tests/test_condense.py`` (N = 40, 5, 1, 64), to 1e-10;
  * the blocked ``cholesky``, ``cho_solve``, ``cholesky_invdiag`` and
    ``cho_solve_invdiag`` at n = 8, 81, 84 and 163 against the JAX
    package's (run eagerly: its unrolled recursions trace for minutes
    under ``jit``), to 1e-12 relative on SPD matrices, and on one
    indefinite at its last pivot, which the JAX package clamps at 1e-30
    (a finite, meaningless factor): the same factor and solves to 1e-9
    relative, where K6's plain version gives NaN;
  * ``solve_qp(chol="blocked")`` against ``chol="lapack"`` on the
    dynamic LTV QP, dense and generator-factored, with the polish;
  * ``interpolate_ddd`` against the JAX package's;
  * the native active-set QP against the JAX package's build of the same
    source, bit for bit, and against the port's f64 IPM at the JAX
    package's tolerances (``tests/test_native.py``), and the native CSV
    reader against numpy on the three track files, bit for bit.

The file keeps six tests or fewer (xdist's ``--dist loadfile`` queues
files by test count).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fsae_mpc_tpu.ops.condense import condense_dnc as jcondense_dnc
from fsae_mpc_tpu.ops import linalg as jlinalg
from fsae_mpc_tpu.runtime import qp_solve_activeset as jqp_solve_activeset
from fsae_mpc_tpu.track import spline as jspline

from fsae_mpc_tpu_torch.config import MPC_F32, VehicleParams
from fsae_mpc_tpu_torch.mpc import ltv
from fsae_mpc_tpu_torch.ops import ipm, linalg
from fsae_mpc_tpu_torch.ops.condense import condense_dnc
from fsae_mpc_tpu_torch.ops.kernels import chol as kchol
from fsae_mpc_tpu_torch.runtime import (native_available,
                                        qp_solve_activeset, read_matrix)
from fsae_mpc_tpu_torch.track import load_track, spline
from fsae_mpc_tpu_torch.utils.io import read_raceline_csv


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are tiny: one intra-op thread keeps this file's
    PyTorch work off the cores that the suite's other files share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


F64 = torch.float64
TRACKS = ("fsg2019", "fso2020", "fss2019")
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=F64)


def test_condense_dnc_matches_jax():
    rng = np.random.default_rng(7)
    for N, nx, nu in [(40, 7, 2), (5, 3, 2), (1, 4, 2), (64, 5, 1)]:
        Ad = rng.standard_normal((2, N, nx, nx)) * 0.3 + np.eye(nx)
        Bd = rng.standard_normal((2, N, nx, nu))
        dd = rng.standard_normal((2, N, nx))
        out = condense_dnc(_t(Ad), _t(Bd), _t(dd))
        ref = jax.jit(jax.vmap(jcondense_dnc)).lower(
            Ad, Bd, dd).compile(compiler_options=FAST_COMPILE)(Ad, Bd, dd)
        for o, r in zip(out, ref):
            assert o.shape == r.shape
            np.testing.assert_allclose(o.numpy(), np.asarray(r),
                                       rtol=1e-10, atol=1e-10)
    assert ltv.CONDENSERS["dnc"] is condense_dnc


def test_blocked_cholesky_matches_jax():
    """At each n: instance 0 SPD (its diagonal spread over four decades),
    instance 1 indefinite at its last pivot, which the JAX package clamps
    (an indefinite pivot earlier clamps every later one and overflows)."""
    for n in (8, 81, 84, 163):
        _check_blocked_cholesky(n)


def _check_blocked_cholesky(n):
    rng = np.random.default_rng(n)
    M = rng.standard_normal((2, n, n))
    A = M @ M.transpose(0, 2, 1) + n * np.eye(n)
    A[0] *= np.outer(*(2 * [np.logspace(0, 2, n)]))
    A[1, -1, -1] -= 1e3 * n
    b = rng.standard_normal((2, n))
    Lt = linalg.cholesky(_t(A))
    Lit, Dit = linalg.cholesky_invdiag(_t(A))
    xt = linalg.cho_solve(Lt, _t(b))
    xit = linalg.cho_solve_invdiag(Lit, Dit, _t(b))
    jA, jb = jnp.asarray(A), jnp.asarray(b)
    Lj = jlinalg.cholesky(jA)
    Lij, Dij = jlinalg.cholesky_invdiag(jA)
    xj = jlinalg.cho_solve(Lj, jb)
    xij = jlinalg.cho_solve_invdiag(Lij, Dij, jb)
    pairs = {"cholesky": (Lt, Lj), "cholesky_invdiag L": (Lit, Lij),
             "cholesky_invdiag Dinv": (Dit, Dij), "cho_solve": (xt, xj),
             "cho_solve_invdiag": (xit, xij)}
    for name, (p, j) in pairs.items():
        p, j = p.numpy(), np.asarray(j)
        assert np.isfinite(p).all() and np.isfinite(j).all(), name
        np.testing.assert_allclose(p[0], j[0], rtol=1e-12,
                                   atol=1e-12 * np.abs(j[0]).max(),
                                   err_msg=name)
        # the clamped pivot: the same finite factor and solves
        np.testing.assert_allclose(p[1], j[1], rtol=1e-9,
                                   atol=1e-9 * np.abs(j[1]).max(),
                                   err_msg=name)
    # the SPD factor is a Cholesky factor; the indefinite one is finite
    # where K6's plain version poisons it with NaN
    LL = Lt[0] @ Lt[0].mT
    assert float((LL - _t(A[0])).abs().max()) < 1e-12 * np.abs(A[0]).max()
    assert float(Lt[1, -1, -1]) < -1e15          # s / sqrt(1e-30), s < 0
    assert torch.isnan(kchol.factor_ref(_t(A))[1]).all()
    with pytest.raises(ValueError, match="divisible"):
        linalg.cholesky_invdiag(_t(A), block=5 if n % 5 else 3)


def test_blocked_route_solves_like_lapack():
    """The dense IPM on ``chol="blocked"`` (KKT factor and solves, the
    polish's) against ``chol="lapack"``, on the dynamic LTV QP at N=8,
    dense and generator-factored."""
    N, B = 8, 2
    mpc = dataclasses.replace(MPC_F32, n_steps=N)
    track, _ = load_track("data/fsg2019.csv", dtype=F64, device="cpu")
    t = mpc.dt * np.arange(1, N + 1)
    x_lin = np.zeros((B, N, 7))
    x_lin[:, :, 0] = 8.0 * t
    x_lin[:, :, 3] = 8.0
    x0 = np.zeros((B, 7))
    x0[:, 0] = [3.0, 41.0]
    x0[:, 1] = [0.1, -0.15]
    x0[:, 3] = 8.0
    x_ref = np.zeros((B, N, 7))
    x_ref[:, :, 3] = np.minimum(8.0 + 10.0 * t, 20.0)
    x_ref[:, :, 0] = x0[:, 0:1] + np.cumsum(x_ref[:, :, 3] * mpc.dt, 1)
    opts = ipm.IpmOptions(max_iters=40, polish=2)
    for structured in (False, "gen"):
        qp, _ = ltv.build_qp_dynamic(_t(x0), _t(x_ref), track,
                                     VehicleParams(), mpc, _t(x_lin),
                                     torch.zeros((B, N, 2), dtype=F64),
                                     structured=structured)
        ref = ipm.solve_qp(*qp[:7], dataclasses.replace(opts, chol="lapack"))
        res = ipm.solve_qp(*qp[:7], dataclasses.replace(opts,
                                                        chol="blocked"))
        np.testing.assert_allclose(res.x.numpy(), ref.x.numpy(), rtol=0,
                                   atol=1e-8, err_msg=str(structured))
        np.testing.assert_allclose(res.objective.numpy(),
                                   ref.objective.numpy(), rtol=1e-10)


def test_interpolate_ddd_matches_jax():
    track, _ = load_track("data/fsg2019.csv", dtype=F64, device="cpu")
    rng = np.random.default_rng(2)
    s = rng.uniform(-20.0, float(track.L) + 20.0, (3, 17))
    got = spline.interpolate_ddd(_t(s), track.px, track.dl)
    ref = jspline.interpolate_ddd(jnp.asarray(s), jnp.asarray(track.px),
                                  jnp.asarray(track.dl))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12,
                               atol=1e-12)
    # the third derivative of a cubic is constant across a segment
    mid = spline.interpolate_ddd(_t(s) + 1e-3, track.px, track.dl)
    seg = lambda v: torch.floor(torch.remainder(v, track.L) / track.dl)
    same = seg(_t(s)) == seg(_t(s) + 1e-3)
    assert torch.equal(got[same], mid[same])


def _random_qp(rng, n, m):
    M = rng.normal(size=(n, n))
    H = M @ M.T + n * np.eye(n)
    g = rng.normal(size=n) * 2.0
    A = rng.normal(size=(m, n))
    lb = -1.0 - rng.uniform(size=n)
    ub = 1.0 + rng.uniform(size=n)
    lbA = -1.0 - rng.uniform(size=m)
    ubA = 1.0 + rng.uniform(size=m)
    return H, g, A, lb, ub, lbA, ubA


def test_native_active_set_matches_ipm():
    """Five random QPs (n=8, m=6) and the kinematic LTV QP at N=6: the
    native Goldfarb-Idnani solver (numpy in, and CPU tensors in) against
    the JAX package's build of the same source, bit for bit, and against
    the port's f64 dense IPM, at the JAX package's tolerances."""
    assert native_available()
    for seed in range(5):
        qp = _random_qp(np.random.default_rng(seed), 8, 6)
        x_as, obj_as, status = qp_solve_activeset(*qp)
        assert status == 0
        x_j, obj_j, status_j = jqp_solve_activeset(*qp)
        np.testing.assert_array_equal(x_as, x_j)
        assert (obj_as, status) == (obj_j, status_j)
        res = ipm.solve_qp(*(_t(v)[None] for v in qp))
        np.testing.assert_allclose(x_as, res.x[0].numpy(), atol=1e-6)
        assert abs(obj_as - float(res.objective[0])) < 1e-7 * max(
            1.0, abs(obj_as))
        x_t, obj_t, _ = qp_solve_activeset(*(_t(v) for v in qp))
        np.testing.assert_array_equal(x_t, x_as)
    N = 6
    mpc = dataclasses.replace(MPC_F32, n_steps=N)
    track, _ = load_track("data/fsg2019.csv", dtype=F64, device="cpu")
    t = mpc.dt * np.arange(1, N + 1)
    x_lin = np.zeros((1, N, 5))
    x_lin[0, :, 0] = 8.0 * t
    x_lin[0, :, 3] = 8.0
    x_ref = np.zeros((1, N, 5))
    x_ref[0, :, 3] = 8.0 + 0.5 * np.arange(1, N + 1)
    x_ref[0, :, 0] = np.cumsum(x_ref[0, :, 3] * mpc.dt)
    x0 = np.array([[0.0, 0.1, 0.05, 8.0, 0.0]])
    qp, _ = ltv._build_condensed("kinematic", _t(x0), _t(x_ref), track,
                                 VehicleParams(), mpc, _t(x_lin),
                                 torch.zeros((1, N, 2), dtype=F64), "rk2",
                                 None)
    x_as, obj_as, status = qp_solve_activeset(*(v[0] for v in qp[:7]),
                                              max_iter=2000)
    assert status == 0
    x_j, obj_j, status_j = jqp_solve_activeset(
        *(v[0].numpy() for v in qp[:7]), max_iter=2000)
    np.testing.assert_array_equal(x_as, x_j)
    assert (obj_as, status) == (obj_j, status_j)
    res = ipm.solve_qp(*qp[:7])
    np.testing.assert_allclose(x_as[:2 * N], res.x[0, :2 * N].numpy(),
                               atol=1e-5)
    with pytest.raises(ValueError, match="CPU tensors"):
        qp_solve_activeset(*(v.to("meta") for v in (qp[0][0], qp[1][0])),
                           *(v[0] for v in qp[2:7]))


def test_native_csv_matches_numpy():
    """The native reader gives numpy's array, bit for bit, on every track
    file, and ``read_raceline_csv`` (numpy) its columns."""
    for name in TRACKS:
        path = f"data/{name}.csv"
        got = read_matrix(path)
        ref = np.genfromtxt(path, delimiter=",", skip_header=1)
        np.testing.assert_array_equal(got, ref, err_msg=name)
        cols = read_raceline_csv(path)
        np.testing.assert_array_equal(cols["x"], ref[:, 0])
        np.testing.assert_array_equal(cols["ly"], ref[:, 10])
