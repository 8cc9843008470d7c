"""Trapezoidal-collocation NMPC: PyTorch port against the JAX package.

``trapezoidal_nmpc_kinematic`` and ``trapezoidal_nmpc_dynamic`` (three
SQP iterations over the N+1 collocation points) on both QP backends --
dense: ``condense_general``'s two-control recurrence and the non-aligned
condensed assembly (NC = N+1 controls); Riccati: the stage QP on the
augmented state z = [x; u] (nz = 7 and 9, N+1 stages) -- in f64 on the
CPU, on fsg2019 with the real vehicle and ``MPC_F32`` at N=8, for a batch
of two instances, under ``F32_OPTS``.  Inputs are made with numpy and
handed to both packages.  Each JAX configuration is ONE warm subproblem
program (``sqp_iters=1`` with ``warm``), traced once per instance and run
three times from the zero warm start, each run from the last one's
trajectory and solver state: the semantics of ``run_sqp`` given a warm
start, which the port runs with ``sqp_iters=3``.  The building blocks are
held on their own, on seeded near-identity data: ``solve_unrolled``,
``condense_general`` at stride 1 and at stride 2 (Hermite-Simpson's
three-control coupling), ``_trapezoidal_stage_qp``'s arrays and the
condensed QP of the same rows.

Tolerances.  Both sides run the same f64 algorithm in another summation
order; three SQP iterations amplify it by the KKT conditioning and the
relinearisation (measured: controls and states within 3.6e-14, slacks
3e-20 absolute, the objective 3.4e-13 relative).  Controls, states and
slacks are held to 1e-8 absolute, the objective to 1e-8 relative,
iteration counts exactly; the building blocks to 1e-10 relative and
absolute.

The two backends solve the same subproblems: SQP on each from a cold
start, with a tight f64 IPM, lands on the same trajectory (the JAX
package's bar for that comparison, ``tests/test_nmpc.py``: 3e-5).
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fsae_mpc_tpu import config as jconfig
from fsae_mpc_tpu.mpc import collocation as jcol
from fsae_mpc_tpu.mpc import constraints as jcons
from fsae_mpc_tpu.mpc import ltv as jltv
from fsae_mpc_tpu.ops import ipm as jipm
from fsae_mpc_tpu.ops import riccati as jriccati
from fsae_mpc_tpu.ops.condense import condense_general as jcondense_general
from fsae_mpc_tpu.ops.linalg import solve_unrolled as jsolve_unrolled
from fsae_mpc_tpu.track import load_track as jload_track

from fsae_mpc_tpu_torch import interop
from fsae_mpc_tpu_torch.config import MPC_F32, VehicleParams
from fsae_mpc_tpu_torch.mpc import collocation as col
from fsae_mpc_tpu_torch.mpc import constraints as cons
from fsae_mpc_tpu_torch.mpc import ltv
from fsae_mpc_tpu_torch.ops import ipm
from fsae_mpc_tpu_torch.ops.condense import condense_general
from fsae_mpc_tpu_torch.ops.linalg import solve_unrolled
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
SQP_ITERS = 3
F64 = torch.float64
ATOL = 1e-8
FVAL_RTOL = 1e-8
BLOCK_TOL = 1e-10
BACKENDS = ("dense", "riccati")
MODELS = {"kinematic": 5, "dynamic": 7}
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}
# the subproblem's widths: dense (variables, rows), Riccati (stages, nz,
# rows a stage, slacks); rows at points 1..N: speed and steering box,
# track and (kinematic) lateral acceleration, two sides each; dynamic: the
# ellipse at points 0..N, one side
WARM_DIMS = {("kinematic", "dense"): (2 * N + 3, 6 * N),
             ("kinematic", "riccati"): (N + 1, 7, 6, 1),
             ("dynamic", "dense"): (2 * N + 4, 5 * N + 1),
             ("dynamic", "riccati"): (N + 1, 9, 5, 2)}
WARM_OF = {"dense": (jipm.IpmResult, interop.ipm_result),
           "riccati": (jriccati.StageIpmResult, interop.stage_ipm_result)}
FNS = {"kinematic": col.trapezoidal_nmpc_kinematic,
       "dynamic": col.trapezoidal_nmpc_dynamic}


def _inputs(nx, dt):
    """x0, x_ref (points 1..N) and the starting iterate over points 0..N
    of two instances, from a numpy seed."""
    rng = np.random.default_rng(11)
    x0 = np.zeros((B, nx))
    x0[:, 0] = rng.uniform(0.0, 100.0, B)
    x0[:, 1] = rng.uniform(-0.15, 0.15, B)
    x0[:, 2] = rng.uniform(-0.02, 0.02, B)
    x0[:, 3] = rng.uniform(7.0, 9.0, B)
    v = np.minimum(x0[:, 3:4] + 10.0 * dt * np.arange(1, N + 1), 20.0)
    x_ref = np.zeros((B, N, nx))
    x_ref[:, :, 3] = v
    x_ref[:, :, 0] = x0[:, 0:1] + np.cumsum(v * dt, axis=1)
    x_init = np.zeros((B, N + 1, nx))
    x_init[:, :, 0] = x0[:, 0:1] + x0[:, 3:4] * dt * np.arange(N + 1)
    x_init[:, :, 3] = x0[:, 3:4]
    return x0, x_ref, x_init, np.zeros((B, N + 1, 2))


def _block_inputs():
    """Seeded data of the dynamic model's shapes (nx = 7): near-identity
    implicit factors M and right-hand sides R for ``solve_unrolled``, a
    two- and a three-control recurrence, and collocation points."""
    rng = np.random.default_rng(12)
    nx = 7
    x0, x_ref, x_pts, u_pts = _inputs(nx, 0.05)
    x_pts = x_pts + 0.01 * rng.standard_normal(x_pts.shape)
    u_pts = u_pts + 0.5 * rng.standard_normal(u_pts.shape)
    return dict(
        M=np.eye(nx) + 0.05 * rng.standard_normal((B, N, nx, nx)),
        R=rng.standard_normal((B, N, nx, 3)),
        Ad=np.eye(nx) + 0.05 * rng.standard_normal((B, N, nx, nx)),
        Ba=0.05 * rng.standard_normal((B, N, nx, 2)),
        Bb=0.05 * rng.standard_normal((B, N, nx, 2)),
        B2=0.05 * rng.standard_normal((B, N, nx, 2)),
        dd=0.1 * rng.standard_normal((B, N, nx)),
        x0=x0, x_ref=x_ref, x_pts=x_pts, u_pts=u_pts)


def _groups(cons_, mpc, params, x_pts, u_pts):
    """The trapezoidal dynamic subproblem's rows with either package's
    constraint module (per instance for JAX, batched for the port): the
    box and track groups at points 1..N, the ellipse at points 0..N."""
    groups = [
        cons_.state_box_group([3, 6], np.array([0.0, -mpc.delta_max]),
                              np.array([np.inf, mpc.delta_max]),
                              np.array([-1, -1]), x_pts[..., 1:, :],
                              u_pts[..., 1:, :]),
        cons_.state_box_group([1], np.array([-mpc.n_max]),
                              np.array([mpc.n_max]), np.array([0]),
                              x_pts[..., 1:, :], u_pts[..., 1:, :])]
    fr = cons_.friction_ellipse_group(
        x_pts, u_pts, mpc, params, slack=1,
        state_rows=np.concatenate([[-1], np.arange(N)]),
        ctrl_cols=np.arange(N + 1))
    return groups, fr


@pytest.fixture(scope="module")
def jax_results():
    mpc = dataclasses.replace(jconfig.MPC_F32, n_steps=N)
    track, _ = jload_track("data/fsg2019.csv", dtype=jnp.float64)
    params = jconfig.VehicleParams()
    fns = {"kinematic": jcol.trapezoidal_nmpc_kinematic,
           "dynamic": jcol.trapezoidal_nmpc_dynamic}
    inputs = {m: [jnp.asarray(a) for a in _inputs(nx, mpc.dt)]
              for m, nx in MODELS.items()}
    warm = {k: _zero_warm(k[1], d) for k, d in WARM_DIMS.items()}
    blk = {k: jnp.asarray(v) for k, v in _block_inputs().items()}

    def subproblem(model, backend):
        return lambda x0, x_ref, x_init, u_init, w: fns[model](
            x0, x_ref, track, params, mpc, x_init, u_init, jipm.F32_OPTS,
            sqp_iters=1, warm=w, backend=backend)

    def blocks(M, R, Ad, Ba, Bb, B2, dd, x0, x_ref, x_pts, u_pts):
        x_pts = x_pts.at[0].set(x0)
        groups, fr = _groups(jcons, mpc, params, x_pts, u_pts)
        n = N + 1
        q_diag, r_diag = jcol._collocation_weights(mpc, 7, N, x0.dtype)
        u_lb = jnp.tile(jnp.asarray([-jnp.inf, -mpc.delta_d_max]), (n, 1))
        u_ub = -u_lb
        r_soft = [mpc.w_track, mpc.w_slip]
        cg1 = jcondense_general(Ad, dd, [(Ba, 0), (Bb, 1)], n_controls=n)
        cg2 = jcondense_general(Ad, dd, [(Ba, 0), (Bb, 1), (B2, 2)],
                                n_controls=2 * N + 1, ctrl_stride=2)
        stage = jcol._trapezoidal_stage_qp(
            x0, x_ref, q_diag, r_diag, r_soft, groups, fr, Ad, Ba, Bb, dd,
            u_lb, u_ub)
        dense = jltv.assemble_condensed_qp(
            *cg1, x0, x_ref, q_diag, r_diag, r_soft, groups + [fr], u_lb,
            u_ub)
        return jsolve_unrolled(M, R), cg1, cg2, stage, dense

    def warm_of(k, b):
        return WARM_OF[k[1]][0](**{f: jnp.asarray(v[b])
                                   for f, v in warm[k].items()})

    stack = lambda runs: jax.tree_util.tree_map(
        lambda *xs: np.stack([np.asarray(x) for x in xs]), *runs)

    def chain(k, low):
        fn = low.compile(compiler_options=FAST_COMPILE)
        runs = []
        for b in range(B):
            x0, x_ref, x_it, u_it = [a[b] for a in inputs[k[0]]]
            w = warm_of(k, b)
            for _ in range(SQP_ITERS):
                res = fn(x0, x_ref, x_it, u_it, w)
                x_it, u_it, w = res.x_opt, res.u_opt, res.qp
            runs.append(res)
        return stack(runs)

    def run_blocks(low):
        fn = low.compile(compiler_options=FAST_COMPILE)
        return stack([fn(*[v[b] for v in blk.values()]) for b in range(B)])

    # each program is compiled and run on a worker thread (XLA compiles
    # without the GIL) while the next one is traced; the tests take the
    # results when they need them, after their own PyTorch work
    pool = ThreadPoolExecutor(len(WARM_DIMS) + 1)
    futs = {k: pool.submit(chain, k, jax.jit(subproblem(*k)).lower(
        *[a[0] for a in inputs[k[0]]], warm_of(k, 0))) for k in WARM_DIMS}
    futs["blocks"] = pool.submit(run_blocks, jax.jit(blocks).lower(
        *[v[0] for v in blk.values()]))
    yield futs, warm
    pool.shutdown()


def _zero_warm(backend, dims):
    """The last subproblem's solver result with every entry 0, batched, as
    numpy: dense ``dims = (n, m)`` (variables, rows), Riccati ``(stages,
    nz, r, ns)``.  The IPM floors it, as the closed loop's first tick's."""
    if backend == "dense":
        n, m = dims
        shapes = dict(x=(n,), z_bounds=(n,), z_rows=(m,))
    else:
        st, nx, r, ns = dims
        shapes = dict(u=(st, 2), x=(st, nx), s=(ns,), lam=(st, nx),
                      z_u=(st, 2), z_s=(ns,), z_rows=(st, r))
    out = {k: np.zeros((B,) + v) for k, v in shapes.items()}
    out.update(iterations=np.zeros(B, np.int32), mu=np.zeros(B),
               primal_res=np.zeros(B), dual_res=np.zeros(B),
               objective=np.zeros(B))
    return out


@pytest.fixture(scope="module")
def port_setup():
    mpc = dataclasses.replace(MPC_F32, n_steps=N)
    track, _ = load_track("data/fsg2019.csv", dtype=F64, device="cpu")
    return mpc, track, VehicleParams()


def _port_inputs(model, dt):
    return [torch.tensor(a, dtype=F64) for a in _inputs(MODELS[model], dt)]


@pytest.mark.parametrize("model", list(MODELS))
def test_trapezoidal_nmpc_matches_jax(model, jax_results, port_setup):
    """Both backends: the trajectory over the N+1 points, slacks,
    objective and the last subproblem's solver state."""
    mpc, track, params = port_setup
    args = _port_inputs(model, mpc.dt)
    for backend in BACKENDS:
        warm = WARM_OF[backend][1](jax_results[1][model, backend],
                                   dtype=F64, device="cpu")
        res = FNS[model](*args[:2], track, params, mpc, *args[2:],
                         ipm.F32_OPTS, sqp_iters=SQP_ITERS, warm=warm,
                         backend=backend)
        ref = jax_results[0][model, backend].result()
        assert res.x_opt.shape == (B, N + 1, MODELS[model])
        for name in ("u_opt", "x_opt", "slack"):
            np.testing.assert_allclose(
                getattr(res, name).numpy(), getattr(ref, name), rtol=0,
                atol=ATOL, err_msg=f"{backend} {name}")
        np.testing.assert_allclose(res.fval.numpy(), ref.fval,
                                   rtol=FVAL_RTOL, err_msg=backend)
        np.testing.assert_array_equal(res.qp.iterations.numpy(),
                                      ref.qp.iterations, err_msg=backend)
        np.testing.assert_allclose(res.qp.primal_res.numpy(),
                                   ref.qp.primal_res, rtol=0, atol=ATOL,
                                   err_msg=backend)


def _close(got, ref, what):
    assert got.shape == ref.shape, what
    np.testing.assert_allclose(got.numpy(), ref, rtol=BLOCK_TOL,
                               atol=BLOCK_TOL, err_msg=what)


def test_collocation_blocks_match_jax(jax_results, port_setup):
    """``solve_unrolled``; ``condense_general`` at stride 1 and 2; the
    trapezoidal dynamic subproblem's stage QP on the augmented state
    (every field) and its condensed QP (non-aligned: NC = N+1, the ellipse
    rows read x0 at point 0).  Mixed hard and soft rows in one group
    raise ``ValueError``."""
    mpc, _, params = port_setup
    blk = {k: torch.tensor(v, dtype=F64)
           for k, v in _block_inputs().items()}
    x0 = blk["x0"]
    x_pts = torch.cat([x0[:, None], blk["x_pts"][:, 1:]], 1)
    groups, fr = _groups(cons, mpc, params, x_pts, blk["u_pts"])
    n = N + 1
    q_diag, r_diag = col._collocation_weights(mpc, 7, N, F64, "cpu")
    u_lb = torch.tensor([-np.inf, -mpc.delta_d_max],
                        dtype=F64).repeat(B, n, 1)
    r_soft = [mpc.w_track, mpc.w_slip]
    Ad, Ba, Bb, B2, dd = (blk[k] for k in ("Ad", "Ba", "Bb", "B2", "dd"))
    cg1 = condense_general(Ad, dd, [(Ba, 0), (Bb, 1)], n_controls=n)
    cg2 = condense_general(Ad, dd, [(Ba, 0), (Bb, 1), (B2, 2)],
                           n_controls=2 * N + 1, ctrl_stride=2)
    stage, const = col._trapezoidal_stage_qp(
        x0, blk["x_ref"], q_diag, r_diag, r_soft, groups, fr, Ad, Ba, Bb,
        dd, u_lb, -u_lb)
    dense = ltv.assemble_condensed_qp(*cg1, x0, blk["x_ref"], q_diag,
                                      r_diag, r_soft, groups + [fr], u_lb,
                                      -u_lb)
    X_ref, cg1_ref, cg2_ref, (stage_ref, const_ref), dense_ref = \
        jax_results[0]["blocks"].result()
    _close(solve_unrolled(blk["M"], blk["R"]), X_ref, "solve_unrolled")
    for i in range(3):
        _close(cg1[i], cg1_ref[i], f"condense_general stride 1 [{i}]")
        _close(cg2[i], cg2_ref[i], f"condense_general stride 2 [{i}]")
    for f in dataclasses.fields(stage):
        _close(getattr(stage, f.name), getattr(stage_ref, f.name),
               f"stage QP {f.name}")
    _close(const, const_ref, "stage QP const")
    assert (stage.Ad.shape[1], stage.Ad.shape[-1]) == (N + 1, 9)
    for i, (a, b) in enumerate(zip(dense, dense_ref)):
        _close(a, b, f"condensed QP [{i}]")
    mixed = dataclasses.replace(groups[1], lb=np.array([-1.0, -1.0]),
                                ub=np.array([1.0, 1.0]),
                                slack_idx=np.array([-1, 0]),
                                C=groups[1].C.repeat(1, 1, 2, 1),
                                D=groups[1].D.repeat(1, 1, 2, 1),
                                offset_const=groups[1].offset_const.repeat(
                                    1, 1, 2))
    with pytest.raises(ValueError, match="mix of hard/soft"):
        col._trapezoidal_stage_qp(x0, blk["x_ref"], q_diag, r_diag, r_soft,
                                  [mixed], None, Ad, Ba, Bb, dd, u_lb,
                                  -u_lb)


@pytest.mark.parametrize("model", list(MODELS))
def test_trapezoidal_backends_share_the_minimiser(model, port_setup):
    """SQP on the augmented-state stage QP lands on the condensed
    two-control-coupled QP's trajectory."""
    mpc, track, params = port_setup
    args = _port_inputs(model, mpc.dt)
    res = {b: FNS[model](*args[:2], track, params, mpc, *args[2:],
                         ipm.IpmOptions(max_iters=25), sqp_iters=SQP_ITERS,
                         backend=b)
           for b in BACKENDS}
    for name in ("u_opt", "x_opt"):
        np.testing.assert_allclose(getattr(res["riccati"], name).numpy(),
                                   getattr(res["dense"], name).numpy(),
                                   rtol=0, atol=3e-5, err_msg=name)
