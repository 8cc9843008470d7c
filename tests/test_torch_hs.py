"""Hermite-Simpson collocation NMPC: the PyTorch port against the JAX
package, and the dense Cholesky plain versions past n = 152.

In f64 on the CPU, on fsg2019 with the real vehicle and ``MPC_F32`` at
N=8, for a batch of two instances, under ``F32_OPTS``; inputs made with
numpy from a seed and handed to both packages:

  * ``_hs_stages`` (the knot recurrence and the midpoint map) on seeded
    points around the instances' trajectories;
  * ``hs_nmpc_kinematic`` (two SQP iterations over the 2N+1 points:
    ``condense_general`` at stride 2, the midpoint maps' placement, the
    non-aligned condensed QP over (2N+1) nu + 1 variables) and
    ``hs_shift_trajectory`` of its result by two rk2 half-steps;
  * the closed loop ``simulate`` with ``mode="c-nmpc",
    transcription="hs"`` for a few ticks, one SQP iteration a tick (the
    JAX package traces each SQP iteration of a tick's program anew, ~3.5 s
    each on one core; the warm-started later iterations are held in the
    test above); instance 0 rolling at 4 m/s from the origin, instance 1
    at 6 m/s 5 m down the track (from rest the plant amplifies a
    last-digit difference ~1e7-fold within 20 substeps, see
    ``test_torch_closed_loop.py``);
  * ``condense_associative`` on a near-identity recurrence of 13 stages
    (not a power of two);
  * the plain versions of the dense Cholesky factor and solve (what the
    kernel wrappers run on the CPU) at n = 163 (the Hermite-Simpson QP at
    N = 40) and n = 192 (the kernels' widest), against
    ``jnp.linalg.cholesky`` and ``cho_solve``.

The JAX references are ONE program (``jax.vmap`` over the instances),
traced once and compiled on a worker thread while the port runs.

Tolerances.  Both sides run the same f64 algorithm in another summation
order (measured: HS states within 1.4e-14, controls 4e-15, slacks 5e-22,
objectives 4.4e-12 of ~1e2).  Controls, states and slacks are held to
1e-8 absolute, the objective to 1e-8 relative, iteration counts exactly;
the closed loop's every float field to 1e-9 relative and absolute (as
``test_torch_closed_loop.py``), its booleans and counts exactly; the
building blocks to 1e-10.
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import jax.scipy.linalg
import numpy as np
import pytest
import torch

from fsae_mpc_tpu import config as jconfig
from fsae_mpc_tpu.models import curvilinear as jcm
from fsae_mpc_tpu.models import integrators as jint
from fsae_mpc_tpu.models import transforms as jtransforms
from fsae_mpc_tpu.mpc import collocation as jcol
from fsae_mpc_tpu.ops import ipm as jipm
from fsae_mpc_tpu.ops.condense import condense_associative as jcond_assoc
from fsae_mpc_tpu.sim import closed_loop as jsim
from fsae_mpc_tpu.track import load_track as jload_track

from fsae_mpc_tpu_torch import interop
from fsae_mpc_tpu_torch.config import MPC_F32, VehicleParams
from fsae_mpc_tpu_torch.models import curvilinear as cm
from fsae_mpc_tpu_torch.models import integrators
from fsae_mpc_tpu_torch.mpc import collocation as col
from fsae_mpc_tpu_torch.ops.condense import condense_associative
from fsae_mpc_tpu_torch.ops.kernels import chol as kchol
from fsae_mpc_tpu_torch.sim import closed_loop as sim
from fsae_mpc_tpu_torch.track import load_track


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are tiny: one intra-op thread keeps this file's
    PyTorch work off the cores that the suite's other files share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


N = 8
B = 2
NX = 5
NC = 2 * N + 1
SQP_ITERS = 2
TICKS = 3
N_ASSOC = 13
N_CHOL = (163, 192)
F64 = torch.float64
ATOL = 1e-8
FVAL_RTOL = 1e-8
SIM_TOL = 1e-9
BLOCK_TOL = 1e-10
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}
EXACT = ("converged", "active", "solver_iters", "lap_done", "max_iters")
SIM_STARTS = ((0.0, 4.0), (5.0, 6.0))      # (s on the centreline, speed)


def _inputs():
    """x0, the knot references and the starting iterate over the 2N+1
    points (dt/2 apart) of two instances, and seeded points around it."""
    rng = np.random.default_rng(21)
    dt = MPC_F32.dt
    x0 = np.zeros((B, NX))
    x0[:, 0] = rng.uniform(0.0, 100.0, B)
    x0[:, 1] = rng.uniform(-0.15, 0.15, B)
    x0[:, 2] = rng.uniform(-0.02, 0.02, B)
    x0[:, 3] = rng.uniform(7.0, 9.0, B)
    v = np.minimum(x0[:, 3:4] + 10.0 * dt * np.arange(1, N + 1), 20.0)
    x_ref = np.zeros((B, N, NX))
    x_ref[:, :, 3] = v
    x_ref[:, :, 0] = x0[:, 0:1] + np.cumsum(v * dt, axis=1)
    x_init = np.zeros((B, NC, NX))
    x_init[:, :, 0] = x0[:, 0:1] + x0[:, 3:4] * dt / 2 * np.arange(NC)
    x_init[:, :, 3] = x0[:, 3:4]
    u_init = np.zeros((B, NC, 2))
    x_pts = x_init + 0.01 * rng.standard_normal(x_init.shape)
    u_pts = 0.5 * rng.standard_normal(u_init.shape)
    return dict(x0=x0, x_ref=x_ref, x_init=x_init, u_init=u_init,
                x_pts=x_pts, u_pts=u_pts,
                Ad=np.eye(7) + 0.05 * rng.standard_normal((B, N_ASSOC, 7, 7)),
                dd=0.1 * rng.standard_normal((B, N_ASSOC, 7)))


def _chol_inputs(n):
    """SPD matrices whose diagonal spans the dense IPM's range."""
    rng = np.random.default_rng(n)
    M = rng.standard_normal((B, n, n))
    K = (M @ np.swapaxes(M, -1, -2) / n + np.eye(n)
         + 10.0 ** rng.uniform(-1.0, 3.0, (B, n, 1)) * np.eye(n))
    return K, rng.standard_normal((B, n))


def _jax_cfg():
    return jsim.SimConfig(
        model="kinematic", mode="c-nmpc", transcription="hs",
        n_ticks=TICKS, sqp_iters=1, mpc=dataclasses.replace(jconfig.MPC_F32, n_steps=N),
        ipm=jipm.F32_OPTS)


@pytest.fixture(scope="module")
def jax_ref():
    track, _ = jload_track("data/fsg2019.csv", dtype=jnp.float64)
    params = jconfig.VehicleParams()
    mpc = dataclasses.replace(jconfig.MPC_F32, n_steps=N)
    f = lambda x, u: jcm.f_curv_kin(x, u, track, params)
    half = lambda x, u: jint.rk2_step(f, x, u, mpc.dt / 2.0)
    cfg = _jax_cfg()
    x_sim = np.zeros((B, 7))
    for i, (s, v) in enumerate(SIM_STARTS):
        px, py, th = jtransforms.curvilinear_to_cartesian(
            jnp.asarray(s), jnp.asarray(0.0), jnp.asarray(0.0), track)
        x_sim[i, :4] = [float(px), float(py), float(th), v]

    def program(d, chol, x_sim):
        stages = jax.vmap(lambda xk, xm, u: jcol._hs_stages(
            f, xk, xm, u, mpc.dt))(d["x_pts"][:, 0::2], d["x_pts"][:, 1::2],
                                   d["u_pts"])
        res = jax.vmap(lambda x0, xr, xi, ui: jcol.hs_nmpc_kinematic(
            x0, xr, track, params, mpc, xi, ui, jipm.F32_OPTS,
            sqp_iters=SQP_ITERS))(d["x0"], d["x_ref"], d["x_init"],
                                  d["u_init"])
        shift = jax.vmap(lambda x, u: jcol.hs_shift_trajectory(x, u, half))(
            res.x_opt, res.u_opt)
        chols = {}
        for n, (K, b) in chol.items():
            L = jnp.linalg.cholesky(K)
            chols[n] = (L, jax.vmap(lambda L_, b_: jax.scipy.linalg.cho_solve(
                (L_, True), b_))(L, b))
        return dict(
            stages=stages, res=res, shift=shift, chol=chols,
            assoc=jax.vmap(jcond_assoc)(d["Ad"], d["dd"]),
            sim=jax.vmap(lambda xi: jsim.simulate(track, params, cfg, xi))(
                x_sim))

    d = {k: jnp.asarray(v) for k, v in _inputs().items()}
    chol = {str(n): tuple(jnp.asarray(a) for a in _chol_inputs(n))
            for n in N_CHOL}
    low = jax.jit(program).lower(d, chol, jnp.asarray(x_sim))
    pool = ThreadPoolExecutor(1)
    fut = pool.submit(lambda: jax.tree_util.tree_map(np.asarray, low.compile(
        compiler_options=FAST_COMPILE)(d, chol, jnp.asarray(x_sim))))
    yield x_sim, fut
    pool.shutdown()


@pytest.fixture(scope="module")
def port(jax_ref):
    """The port's side of every comparison (run while the JAX program
    compiles)."""
    track, _ = load_track("data/fsg2019.csv", dtype=F64, device="cpu")
    params = VehicleParams()
    mpc = dataclasses.replace(MPC_F32, n_steps=N)
    opts = interop.ipm_options(dataclasses.asdict(jipm.F32_OPTS))
    d = {k: torch.tensor(v, dtype=F64) for k, v in _inputs().items()}
    f = lambda x, u: cm.f_curv_kin(x, u, track, params)
    half = lambda x, u: integrators.rk2_step(f, x, u, mpc.dt / 2.0)
    res = col.hs_nmpc_kinematic(d["x0"], d["x_ref"], track, params, mpc,
                                d["x_init"], d["u_init"], opts,
                                sqp_iters=SQP_ITERS)
    cfg = interop.sim_config(dataclasses.asdict(_jax_cfg()))
    return dict(
        stages=col._hs_stages(f, d["x_pts"][:, 0::2], d["x_pts"][:, 1::2],
                              d["u_pts"], mpc.dt),
        res=res, shift=col.hs_shift_trajectory(res.x_opt, res.u_opt, half),
        assoc=condense_associative(d["Ad"], d["dd"]),
        sim=sim.simulate(track, params, cfg,
                         torch.tensor(jax_ref[0], dtype=F64)))


def test_hs_stages_match_jax(jax_ref, port):
    """The knot recurrence (Ad, B0, B1, B2, dd) and the midpoint map
    (P, Q, Bm0, Bm2, dm), per instance."""
    ref = jax_ref[1].result()["stages"]
    for part, (got_p, ref_p) in enumerate(zip(port["stages"], ref)):
        for k, (a, b) in enumerate(zip(got_p, ref_p)):
            np.testing.assert_allclose(a.numpy(), b, rtol=BLOCK_TOL,
                                       atol=BLOCK_TOL,
                                       err_msg=f"map {part}, output {k}")


def test_hs_nmpc_and_shift_match_jax(jax_ref, port):
    """Two SQP iterations over the 2N+1 points, and the shift by one knot
    (two rk2 half-steps)."""
    ref = jax_ref[1].result()
    res, rr = port["res"], ref["res"]
    assert tuple(res.x_opt.shape) == (B, NC, NX)
    assert tuple(res.u_opt.shape) == (B, NC, 2)
    assert tuple(res.qp.x.shape) == (B, NC * 2 + 1)
    for f_ in ("x_opt", "u_opt", "slack"):
        np.testing.assert_allclose(getattr(res, f_).numpy(),
                                   getattr(rr, f_), rtol=0, atol=ATOL,
                                   err_msg=f_)
    np.testing.assert_allclose(res.fval.numpy(), rr.fval, rtol=FVAL_RTOL)
    np.testing.assert_array_equal(res.qp.iterations.numpy(),
                                  rr.qp.iterations)
    for a, b in zip(port["shift"], ref["shift"]):
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=ATOL)
    assert np.array_equal(port["shift"][0][:, :-2].numpy(),
                          res.x_opt[:, 2:].numpy())


def test_hs_closed_loop_matches_jax(jax_ref, port):
    """``simulate`` with the Hermite-Simpson controller: every trace and
    summary field, per instance."""
    out = jax_ref[1].result()["sim"]
    ref = interop.sim_outputs({f_.name: getattr(out, f_.name) for f_ in
                               dataclasses.fields(out)}, dtype=F64,
                              device="cpu")
    got = port["sim"]
    for f_ in dataclasses.fields(sim.SimOutputs):
        a, b = getattr(got, f_.name), getattr(ref, f_.name)
        assert a.shape == b.shape, f_.name
        if f_.name in EXACT:
            np.testing.assert_array_equal(a.numpy(), b.numpy(),
                                          err_msg=f_.name)
        else:
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=SIM_TOL,
                                       atol=SIM_TOL, err_msg=f_.name)
    # the dynamic model has no Hermite-Simpson controller, as in the JAX
    # package
    cfg = dataclasses.replace(sim.SimConfig(n_ticks=1), mode="c-nmpc",
                              transcription="hs", model="dynamic")
    with pytest.raises(ValueError, match="kinematic-only"):
        sim.simulate(load_track("data/fsg2019.csv", dtype=F64,
                                device="cpu")[0], VehicleParams(), cfg)


def test_condense_associative_matches_jax(jax_ref, port):
    """The log-depth transition and offset products, and the sequential
    recurrence they stand for."""
    ref = jax_ref[1].result()["assoc"]
    A_bar, d_bar = port["assoc"]
    for a, b in ((A_bar, ref[0]), (d_bar, ref[1])):
        np.testing.assert_allclose(a.numpy(), b, rtol=BLOCK_TOL,
                                   atol=BLOCK_TOL)
    d = _inputs()
    phi, delta = np.broadcast_to(np.eye(7), (B, 7, 7)), np.zeros((B, 7))
    for i in range(N_ASSOC):
        phi = d["Ad"][:, i] @ phi
        delta = np.einsum("bij,bj->bi", d["Ad"][:, i], delta) + d["dd"][:, i]
        np.testing.assert_allclose(A_bar[:, i].numpy(), phi,
                                   rtol=BLOCK_TOL, atol=BLOCK_TOL)
        np.testing.assert_allclose(d_bar[:, i].numpy(), delta,
                                   rtol=BLOCK_TOL, atol=BLOCK_TOL)


@pytest.mark.parametrize("n", N_CHOL)
def test_chol_plain_versions_past_152(n, jax_ref):
    """The dense Cholesky wrappers on CPU tensors (their plain versions)
    at the Hermite-Simpson width and the kernels' widest, which the entry
    check accepts on the card under ``chol="auto"``."""
    assert n <= kchol.MAX_N
    kchol.check_entry(torch.device("cuda"), torch.float32, n, "auto")
    K, b = _chol_inputs(n)
    L_ref, x_ref = jax_ref[1].result()["chol"][str(n)]
    L = kchol.factor(torch.tensor(K, dtype=F64))
    x = kchol.solve(L, torch.tensor(b, dtype=F64))
    np.testing.assert_allclose(L.numpy(), L_ref, rtol=BLOCK_TOL,
                               atol=BLOCK_TOL)
    np.testing.assert_allclose(x.numpy(), x_ref, rtol=BLOCK_TOL,
                               atol=BLOCK_TOL)
    assert np.all(np.triu(L.numpy(), 1) == 0.0)
