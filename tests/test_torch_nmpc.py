"""Multiple-shooting NMPC: PyTorch port against the JAX package.

``ms_nmpc_kinematic`` and ``ms_nmpc_dynamic`` (rk2 shooting, three SQP
iterations, each subproblem warm-started from its predecessor, the first
from the zero solver state the IPM floors) on both QP backends, in f64 on
the CPU, on fsg2019 with the real vehicle and ``MPC_F32`` at N=8, for a
batch of two instances with different initial states, under
``F32_OPTS``.  Inputs are made with numpy and handed to both packages.
Each JAX configuration is ONE warm subproblem program (``sqp_iters=1``
with ``warm``), traced once per instance (cheaper than its vmap) and run
three times, each run from the last one's trajectory and solver state:
the semantics of ``run_sqp`` given a warm start, which the port runs with
``sqp_iters=3`` (tracing the cold first subproblem as well would double
the JAX cost; the port's cold start runs in the minimiser test and on
the card).  The programs compile side by side.  The building blocks of
the dynamic model's subproblem are held on their own: the friction-
ellipse group on the pre-step state, the condensed QP of the non-aligned
assembly (the ellipse rows read x0 at stage 0), and the ellipse rows
re-expressed on the stage's post-state for the Riccati backend.

Tolerances.  Both sides run the same f64 algorithm in another summation
order (~1e-16 relative per operation); three SQP iterations of 12 IPM
iterations each amplify it by the KKT conditioning and the relinearisation
(measured: controls and states within 1.4e-14, slacks 1e-19 absolute,
the objective 3.1e-13 relative).  Controls, states and slacks are held to 1e-8
absolute, the objective to 1e-8 relative, iteration counts exactly; the
building blocks to 1e-10 relative and absolute.

The two backends solve the same subproblems: SQP on each from a cold
start, with a tight f64 IPM, lands on the same trajectory (the JAX
package's bar for that comparison, ``tests/test_nmpc.py``: 2e-5).
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fsae_mpc_tpu import config as jconfig
from fsae_mpc_tpu.models import curvilinear as jcm
from fsae_mpc_tpu.models import integrators as jintegrators
from fsae_mpc_tpu.mpc import constraints as jcons
from fsae_mpc_tpu.mpc import ltv as jltv
from fsae_mpc_tpu.mpc import sqp as jsqp
from fsae_mpc_tpu.ops.condense import condense as jcondense
from fsae_mpc_tpu.ops import ipm as jipm
from fsae_mpc_tpu.ops import riccati as jriccati
from fsae_mpc_tpu.track import load_track as jload_track

from fsae_mpc_tpu_torch import interop
from fsae_mpc_tpu_torch.config import MPC_F32, VehicleParams
from fsae_mpc_tpu_torch.models import curvilinear as cm
from fsae_mpc_tpu_torch.models import integrators
from fsae_mpc_tpu_torch.mpc import constraints as cons
from fsae_mpc_tpu_torch.mpc import ltv, sqp
from fsae_mpc_tpu_torch.ops import ipm
from fsae_mpc_tpu_torch.ops.condense import condense
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


def _inputs(nx, dt):
    """x0, x_ref and the SQP's starting trajectory of two instances, from
    a numpy seed: spread along the track, off the centreline, at 7-9
    m/s."""
    rng = np.random.default_rng(9)
    x0 = np.zeros((B, nx))
    x0[:, 0] = rng.uniform(0.0, 100.0, B)
    x0[:, 1] = rng.uniform(-0.15, 0.15, B)
    x0[:, 2] = rng.uniform(-0.02, 0.02, B)
    x0[:, 3] = rng.uniform(7.0, 9.0, B)
    steps = np.arange(1, N + 1)
    v = np.minimum(x0[:, 3:4] + 10.0 * dt * steps, 20.0)
    x_ref = np.zeros((B, N, nx))
    x_ref[:, :, 3] = v
    x_ref[:, :, 0] = x0[:, 0:1] + np.cumsum(v * dt, axis=1)
    x_init = np.zeros((B, N, nx))
    x_init[:, :, 0] = x0[:, 0:1] + x0[:, 3:4] * dt * steps
    x_init[:, :, 3] = x0[:, 3:4]
    u_init = np.zeros((B, N, 2))
    return x0, x_ref, x_init, u_init


def _zero_warm(backend, dims):
    """The last subproblem's solver result with every entry 0, batched, as
    numpy: dense ``dims = (n, m)`` (variables, rows), Riccati ``(stages,
    nx, r, ns)``.  The IPM floors it, as the closed loop's first tick's."""
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


# the subproblem's widths: dense (variables, rows), Riccati (stages, nx,
# rows a stage, slacks); kinematic rows: speed and steering box, track,
# lateral acceleration (two sides each); dynamic: box, track, ellipse
WARM_DIMS = {("kinematic", "dense"): (2 * N + 1, 6 * N),
             ("kinematic", "riccati"): (N, 5, 6, 1),
             ("dynamic", "dense"): (2 * N + 2, 5 * N),
             ("dynamic", "riccati"): (N, 7, 5, 2)}
WARM_OF = {"dense": (jipm.IpmResult, interop.ipm_result),
           "riccati": (jriccati.StageIpmResult, interop.stage_ipm_result)}


def _jax_blocks(track, params, mpc):
    """The dynamic subproblem's building blocks, per instance, at the
    first SQP iterate, from the port's discrete linearisation (held to
    the JAX package's in ``test_torch_models.py``)."""
    pre_rows = np.concatenate([[-1], np.arange(N - 1)])

    def blocks(x0, x_ref, x_lin, u_lin, Ad, Bd, dd):
        x_pre = jnp.concatenate([x0[None], x_lin[:-1]], axis=0)
        fr = jcons.friction_ellipse_group(x_pre, u_lin, mpc, params,
                                          slack=1, state_rows=pre_rows)
        groups = [
            jcons.state_box_group([1], np.array([-mpc.n_max]),
                                  np.array([mpc.n_max]), np.array([0]),
                                  x_lin, u_lin), fr]
        q_diag, r_diag = jsqp._nmpc_weights(mpc, 7, N, x0.dtype)
        u_lb, u_ub = jltv._control_bounds(mpc, N, x0.dtype)
        qp = jltv.assemble_condensed_qp(
            *jcondense(Ad, Bd, dd), x0, x_ref, q_diag, r_diag,
            [mpc.w_track, mpc.w_slip], groups, u_lb, u_ub)
        al = jsqp._align_prestep_group(fr, Ad, Bd, dd, x0)
        return ((fr.C, fr.D, fr.offset_const), qp,
                (al.C, al.D, al.offset_const))
    return blocks


def _port_linearisation(track, params, mpc):
    """The dynamic rk2 step linearised at the pre-step states of the
    first SQP iterate (the port's), batched."""
    x0, x_ref, x_lin, u_lin = _port_inputs("dynamic", mpc.dt)
    f = lambda x, u: cm.f_curv_dyn_only(x, u, track, params)
    step = lambda x, u: integrators.rk2_step(f, x, u, mpc.dt)
    x_pre = torch.cat([x0[:, None], x_lin[:, :-1]], 1)
    return (x0, x_ref, x_lin, u_lin, x_pre,
            *integrators.linearize_discrete(step, x_pre, u_lin))


@pytest.fixture(scope="module")
def jax_results(port_setup):
    """Each (model, backend): ONE warm subproblem program (``sqp_iters=1``
    with ``warm``) run three times per instance, each from the last one's
    trajectory and solver state -- the semantics of ``run_sqp`` given a
    warm start -- from the zero warm start; and the building blocks."""
    mpc = dataclasses.replace(jconfig.MPC_F32, n_steps=N)
    track, _ = jload_track("data/fsg2019.csv", dtype=jnp.float64)
    params = jconfig.VehicleParams()
    fns = {"kinematic": jsqp.ms_nmpc_kinematic,
           "dynamic": jsqp.ms_nmpc_dynamic}
    inputs = {m: [jnp.asarray(a) for a in _inputs(nx, mpc.dt)]
              for m, nx in MODELS.items()}
    warm = {k: _zero_warm(k[1], d) for k, d in WARM_DIMS.items()}
    mpc_p, track_p, params_p = port_setup
    lin = [jnp.asarray(t.numpy())
           for t in _port_linearisation(track_p, params_p, mpc_p)]
    blocks_in = lin[:4] + lin[5:]

    def subproblem(model, backend):
        return lambda x0, x_ref, x_init, u_init, w: fns[model](
            x0, x_ref, track, params, mpc, x_init, u_init, jipm.F32_OPTS,
            sqp_iters=1, warm=w, backend=backend)

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
        return stack([fn(*[a[b] for a in blocks_in]) for b in range(B)])

    # each program is compiled and run on a worker thread (XLA compiles
    # without the GIL) while the next one is traced; the tests take the
    # results when they need them, after their own PyTorch work
    pool = ThreadPoolExecutor(len(WARM_DIMS) + 1)
    futs = {k: pool.submit(chain, k, jax.jit(subproblem(*k)).lower(
        *[a[0] for a in inputs[k[0]]], warm_of(k, 0))) for k in WARM_DIMS}
    futs["blocks"] = pool.submit(run_blocks, jax.jit(
        _jax_blocks(track, params, mpc)).lower(*[a[0] for a in blocks_in]))
    yield futs, warm
    pool.shutdown()


@pytest.fixture(scope="module")
def port_setup():
    mpc = dataclasses.replace(MPC_F32, n_steps=N)
    track, _ = load_track("data/fsg2019.csv", dtype=F64, device="cpu")
    return mpc, track, VehicleParams()


def _port_inputs(model, dt):
    return [torch.tensor(a, dtype=F64) for a in _inputs(MODELS[model], dt)]


FNS = {"kinematic": sqp.ms_nmpc_kinematic, "dynamic": sqp.ms_nmpc_dynamic}


@pytest.mark.parametrize("model", list(MODELS))
def test_ms_nmpc_matches_jax(model, jax_results, port_setup):
    """Both backends: trajectory, slacks, objective and the last
    subproblem's solver state."""
    mpc, track, params = port_setup
    args = _port_inputs(model, mpc.dt)
    for backend in BACKENDS:
        warm = WARM_OF[backend][1](jax_results[1][model, backend],
                                   dtype=F64, device="cpu")
        res = FNS[model](*args[:2], track, params, mpc, *args[2:],
                         ipm.F32_OPTS, sqp_iters=SQP_ITERS, warm=warm,
                         backend=backend)
        ref = jax_results[0][model, backend].result()
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


def test_dynamic_subproblem_blocks_match_jax(jax_results, port_setup):
    """The friction-ellipse group on the pre-step state (row 0 reads x0),
    the condensed QP with those non-aligned rows (rows group-major, stage-
    major within a group), and the rows re-expressed on the post-state
    for the stage-wise solver."""
    mpc, track, params = port_setup
    x0, x_ref, x_lin, u_lin, x_pre, Ad, Bd, dd = _port_linearisation(
        track, params, mpc)
    pre_rows = np.concatenate([[-1], np.arange(N - 1)])
    fr = cons.friction_ellipse_group(x_pre, u_lin, mpc, params, slack=1,
                                     state_rows=pre_rows)
    groups = [cons.state_box_group([1], np.array([-mpc.n_max]),
                                   np.array([mpc.n_max]), np.array([0]),
                                   x_lin, u_lin), fr]
    q_diag, r_diag = sqp._nmpc_weights(mpc, 7, N, F64, "cpu")
    u_lb, u_ub = ltv._control_bounds(mpc, B, N, F64, "cpu")
    qp = ltv.assemble_condensed_qp(
        *condense(Ad, Bd, dd), x0, x_ref, q_diag, r_diag,
        [mpc.w_track, mpc.w_slip], groups, u_lb, u_ub)
    al = sqp._align_prestep_group(fr, Ad, Bd, dd, x0)
    ref_fr, ref_qp, ref_al = jax_results[0]["blocks"].result()
    got = ((fr.C, fr.D, fr.offset_const), qp, (al.C, al.D, al.offset_const))
    for name, g, r in zip(("ellipse group", "condensed QP", "aligned rows"),
                          got, (ref_fr, ref_qp, ref_al)):
        for i, (a, b) in enumerate(zip(g, r)):
            assert a.shape == b.shape, (name, i)
            np.testing.assert_allclose(a.numpy(), b, rtol=BLOCK_TOL,
                                       atol=BLOCK_TOL,
                                       err_msg=f"{name} [{i}]")
    assert fr.state_rows.tolist() == pre_rows.tolist()
    assert al.state_rows.tolist() == list(range(N))
    # the utilisation the closed loop reports
    fcr, a = np.linspace(-2e3, 2e3, 5), np.linspace(-9.0, 9.0, 5)
    np.testing.assert_allclose(
        cons.friction_ellipse_value(torch.tensor(fcr), torch.tensor(a),
                                    params).numpy(),
        np.asarray(jcons.friction_ellipse_value(fcr, a,
                                                jconfig.VehicleParams())),
        rtol=1e-15)


@pytest.mark.parametrize("model", list(MODELS))
def test_ms_backends_share_the_minimiser(model, port_setup):
    """SQP on the Riccati backend (the ellipse rows re-expressed on the
    post-state) lands on the dense backend's trajectory; an unknown
    backend and rows off the pre-step state raise."""
    mpc, track, params = port_setup
    args = _port_inputs(model, mpc.dt)
    res = {b: FNS[model](*args[:2], track, params, mpc, *args[2:],
                         ipm.IpmOptions(max_iters=25), sqp_iters=SQP_ITERS,
                         backend=b)
           for b in BACKENDS}
    for name in ("u_opt", "x_opt"):
        np.testing.assert_allclose(getattr(res["riccati"], name).numpy(),
                                   getattr(res["dense"], name).numpy(),
                                   rtol=0, atol=2e-5, err_msg=name)
    with pytest.raises(ValueError, match="backend"):
        FNS[model](*args[:2], track, params, mpc, *args[2:],
                   backend="sparse")
    nx = MODELS[model]
    grp = cons.state_box_group([1], [-1.0], [1.0], [0], args[2], args[3])
    with pytest.raises(ValueError, match="pre-step"):
        sqp._align_prestep_group(grp, *[torch.zeros(B, N, nx, k)
                                        for k in (nx, 2)],
                                 torch.zeros(B, N, nx), args[0])
