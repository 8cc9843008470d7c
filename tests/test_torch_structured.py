"""Generator-factored constraint rows (``structured="gen"``): the PyTorch
port against the JAX package.

All in f64 on the CPU unless stated, inputs made with numpy from a seed:

  * every ``GenRows`` product, scaling and the dense materialisation
    against the JAX ``GenRows`` on the same numpy factors, to 1e-12; the
    f32 compensated products against the f64 product of the same f32
    factors below 1e-11 relative (the JAX package's bar,
    ``tests/test_structured.py``);
  * ``build_qp_dynamic(structured="gen")`` at N=8 and B=3 with three
    perturbed vehicles (lognormal m, Iz and pD, as the JAX package's
    ``perturbed_params``) against ``jax.vmap`` of the JAX build: every QP
    field to 1e-12 (relative, and absolute for entries near zero), the
    rows the same set as the port's dense build's;
  * the structured tick under ``F32_OPTS``, cold and warm, against the JAX
    package's structured tick of each instance (each compiled once, its
    vehicle a traced argument): controls, states and slacks to 1e-6
    absolute, the objective to 1e-8 relative, as
    ``test_torch_ltv_dense.py`` holds the dense tick;
  * ``F32_ACCURATE`` in f32 on both assemblies at the production shape
    (N=40: 84 variables, 800 rows) against a tight f64 solve, with the JAX
    package's bars for each path; ``structured=True`` and per-instance
    polygon radii raise;
  * a soft group whose lower bounds are finite for only some rows drops
    its whole lower side, in both packages alike (a reference defect the
    port mirrors).

The file keeps six tests or fewer (xdist's ``--dist loadfile`` queues
files by test count).
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fsae_mpc_tpu import config as jconfig
from fsae_mpc_tpu.mpc import constraints as jcons
from fsae_mpc_tpu.mpc import ltv as jltv
from fsae_mpc_tpu.ops import ipm as jipm
from fsae_mpc_tpu.ops import structured as jstructured
from fsae_mpc_tpu.track import load_track as jload_track

from fsae_mpc_tpu_torch import interop
from fsae_mpc_tpu_torch.config import MPC_F32, VehicleParams
from fsae_mpc_tpu_torch.mpc import constraints as cons
from fsae_mpc_tpu_torch.mpc import ltv
from fsae_mpc_tpu_torch.ops import ipm
from fsae_mpc_tpu_torch.ops.condense import condense
from fsae_mpc_tpu_torch.ops.structured import GenRows, is_structured
from fsae_mpc_tpu_torch.track import load_track, track_from_points


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are tiny: one intra-op thread keeps this file's
    PyTorch work off the cores that the suite's other files share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


N = 8
B = 3
F64 = torch.float64
PROD_TOL = 1e-12
ATOL = 1e-6
FVAL_RTOL = 1e-8
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}
PERTURBED = ("m", "Iz", "pD")


def _inputs(mpc):
    t = mpc.dt * np.arange(1, N + 1)
    x_lin = np.zeros((B, N, 7))
    x_lin[:, :, 0] = 8.0 * t
    x_lin[:, :, 3] = 8.0
    u_lin = np.zeros((B, N, 2))
    x0 = np.zeros((B, 7))
    x0[:, 0] = [3.0, 41.0, 97.0]
    x0[:, 1] = [0.1, -0.15, 0.05]
    x0[:, 3] = [8.0, 7.0, 9.0]
    v = np.minimum(x0[:, 3:4] + 10.0 * mpc.dt * np.arange(1, N + 1), 20.0)
    x_ref = np.zeros((B, N, 7))
    x_ref[:, :, 3] = v
    x_ref[:, :, 0] = x0[:, 0:1] + np.cumsum(v * mpc.dt, axis=1)
    x0_w = x0.copy()
    x0_w[:, 0] += 0.2
    return x0, x_ref, x_lin, u_lin, x0_w


def _vehicles():
    """Three vehicles: m, Iz and pD lognormal with 2% spread (the JAX
    package's ``perturbed_params``), drawn with numpy."""
    rng = np.random.default_rng(11)
    base = jconfig.VehicleParams()
    return {k: getattr(base, k) * np.exp(0.02 * rng.standard_normal(B))
            for k in PERTURBED}


@pytest.fixture(scope="module")
def jax_refs():
    """The JAX package's structured build of the batch (``jax.vmap`` over
    the vehicles) and its structured ticks of each instance, compiled on
    worker threads."""
    mpc_j = dataclasses.replace(jconfig.MPC_F32, n_steps=N)
    track_j, _ = jload_track("data/fsg2019.csv", dtype=jnp.float64)
    base = jconfig.VehicleParams()
    veh = _vehicles()
    x0, x_ref, x_lin, u_lin, x0_w = _inputs(mpc_j)

    def params_of(m, Iz, pD):
        return dataclasses.replace(base, m=m, Iz=Iz, pD=pD)

    def build(m, Iz, pD, a, r, xl, ul):
        return jltv.build_qp_dynamic(a, r, track_j, params_of(m, Iz, pD),
                                     mpc_j, xl, ul, structured="gen")[0]

    def tick(m, Iz, pD, a, r, xl, ul, warm=None):
        return jltv.ltv_mpc_dynamic(a, r, track_j, params_of(m, Iz, pD),
                                    mpc_j, xl, ul, jipm.F32_OPTS, warm=warm,
                                    structured="gen")

    f64 = lambda a: jnp.asarray(a, jnp.float64)
    vs = [f64(veh[k]) for k in PERTURBED]
    args = [f64(a) for a in (x0, x_ref, x_lin, u_lin, x0_w)]
    one = [v[0] for v in vs] + [a[0] for a in args[:4]]
    compile_ = lambda low: low.compile(compiler_options=FAST_COMPILE)
    cold_t = jax.jit(tick).trace(*one)
    with ThreadPoolExecutor(3) as pool:
        build_f = pool.submit(compile_, jax.jit(jax.vmap(build)).trace(
            *vs, *args[:4]).lower())
        cold_f = pool.submit(compile_, cold_t.lower())
        warm_f = pool.submit(compile_, jax.jit(tick).trace(
            *one, cold_t.out_info.qp).lower())
        build_c, cold_c, warm_c = (f.result() for f in (build_f, cold_f,
                                                         warm_f))
    per_case = {"cold": [], "warm": []}
    for b in range(B):
        v = [x[b] for x in vs]
        a = [x[b] for x in args]
        cold = cold_c(*v, *a[:4])
        per_case["cold"].append(cold)
        per_case["warm"].append(warm_c(*v, a[4], *a[1:4], cold.qp))
    results = {"build": build_c(*vs, *args[:4]), "vehicles": veh,
               "inputs": (x0, x_ref, x_lin, u_lin, x0_w)}
    for k, rs in per_case.items():
        stack = lambda get: np.stack([np.asarray(get(r)) for r in rs])
        results[k] = dict(
            u_opt=stack(lambda r: r.u_opt), x_opt=stack(lambda r: r.x_opt),
            slack=stack(lambda r: r.slack), fval=stack(lambda r: r.fval),
            qp={f.name: stack(lambda r: getattr(r.qp, f.name))
                for f in dataclasses.fields(jipm.IpmResult)})
    return results


@pytest.fixture(scope="module")
def port_setup(jax_refs):
    mpc = dataclasses.replace(MPC_F32, n_steps=N)
    track, _ = load_track("data/fsg2019.csv", dtype=F64, device="cpu")
    params = dataclasses.replace(VehicleParams(), **{
        k: torch.as_tensor(v, dtype=F64)
        for k, v in jax_refs["vehicles"].items()})
    return mpc, track, params


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=F64)


def _close(a, b, tol, msg=""):
    np.testing.assert_allclose(a, b, rtol=tol, atol=tol, err_msg=msg)


def test_genrows_products_match_jax():
    """Every product of the port's batched GenRows against the JAX
    GenRows of each instance on the same factors; the f32 compensated
    products against the f64 product of the f32 factors."""
    rng = np.random.default_rng(3)
    Bg, S, R, G, ns, n = 2, 5, 20, 7, 4, 19
    Ag = rng.standard_normal((Bg, S, G, n))
    Ag[..., n - ns:] = 0.0                       # slack columns are zero
    W = rng.standard_normal((S, R, G))           # one constant, expanded
    # at most one +-1 slack entry a row, as every assembly emits
    Ws = np.zeros((Bg, S, R, ns))
    np.put_along_axis(Ws, rng.integers(0, ns, (Bg, S, R, 1)),
                      rng.choice([-1.0, 0.0, 1.0], (Bg, S, R, 1)), -1)
    x, base = rng.standard_normal((Bg, n)), rng.standard_normal((Bg, n))
    z = rng.standard_normal((Bg, S * R))
    d, r = rng.uniform(0.1, 2.0, (Bg, S * R)), rng.uniform(0.5, 2.0,
                                                           (Bg, S * R))
    vs = rng.uniform(0.5, 2.0, (Bg, n))
    A = interop.gen_rows(dict(Ag=Ag, W=np.broadcast_to(W, (Bg, S, R, G)),
                              Ws=Ws), device="cpu")
    A = dataclasses.replace(A, W=_t(W).expand(Bg, S, R, G))
    assert is_structured(A) and A.shape == (Bg, S * R, n)
    assert A.W.stride(0) == 0 and A.dtype == F64
    port = {
        "matvec": A.matvec(_t(x)), "rmatvec": A.rmatvec(_t(z)),
        "quadform": A.quadform(_t(d)), "row_sq_norms": A.row_sq_norms(),
        "materialize": A.materialize(),
        "scale_rows": A.scale_rows(_t(r)).materialize(),
        "scale_cols": A.scale_cols(_t(vs)).materialize(),
        "matvec_compensated": sum(A.matvec_compensated(_t(x))),
        "rmatvec_compensated": sum(A.rmatvec_compensated(_t(z), _t(base)))}
    def products(Ag, Ws, x, z, d, r, vs, base):
        J = jstructured.GenRows(Ag=Ag, W=jnp.asarray(W), Ws=Ws)
        return {
            "matvec": J.matvec(x), "rmatvec": J.rmatvec(z),
            "quadform": J.quadform(d), "row_sq_norms": J.row_sq_norms(),
            "materialize": J.materialize(),
            "scale_rows": J.scale_rows(r).materialize(),
            "scale_cols": J.scale_cols(vs).materialize(),
            "matvec_compensated": sum(J.matvec_compensated(x)),
            "rmatvec_compensated": sum(J.rmatvec_compensated(z, base))}

    ins = (Ag, Ws, x, z, d, r, vs, base)
    ref = jax.jit(jax.vmap(products)).lower(*ins).compile(
        compiler_options=FAST_COMPILE)(*ins)
    for k, v in ref.items():
        _close(port[k].numpy(), np.asarray(v), PROD_TOL, k)
    # f32: hi + lo against the f64 product of the f32 factors (~f32^2)
    A32 = A.to(dtype=torch.float32)
    Am = np.einsum("bsrg,bsgn->bsrn", A32.W.double().numpy(),
                   A32.Ag.double().numpy())
    Am[..., n - ns:] += A32.Ws.double().numpy()
    Am = Am.reshape(Bg, S * R, n)
    x32, z32, b32 = (v.astype(np.float32).astype(np.float64)
                     for v in (x, z, base))
    hi, lo = A32.matvec_compensated(torch.tensor(x32, dtype=torch.float32))
    y = hi.double().numpy() + lo.double().numpy()
    truth = np.einsum("bmn,bn->bm", Am, x32)
    scale = np.einsum("bmn,bn->bm", np.abs(Am), np.abs(x32)) + 1e-30
    assert np.max(np.abs(y - truth) / scale) < 1e-11
    hi, lo = A32.rmatvec_compensated(torch.tensor(z32, dtype=torch.float32),
                                     torch.tensor(b32, dtype=torch.float32))
    y = hi.double().numpy() + lo.double().numpy()
    truth = b32 + np.einsum("bmn,bm->bn", Am, z32)
    scale = (np.einsum("bmn,bm->bn", np.abs(Am), np.abs(z32))
             + np.abs(b32) + 1e-30)
    assert np.max(np.abs(y - truth) / scale) < 1e-11


def test_gen_build_matches_jax(jax_refs, port_setup):
    """The structured build of three perturbed vehicles against jax.vmap
    of the JAX build: every QP field and the materialised rows; the rows
    are the dense build's, in stage-major order."""
    mpc, track, params = port_setup
    x0, x_ref, x_lin, u_lin, _ = (_t(a) for a in jax_refs["inputs"])
    qp, _ = ltv.build_qp_dynamic(x0, x_ref, track, params, mpc, x_lin,
                                 u_lin, structured="gen")
    jqp = jax_refs["build"]
    A, JA = qp[2], jqp[2]
    assert isinstance(A, GenRows) and A.shape == (B, 20 * N, 2 * N + 4)
    for name in ("Ag", "W", "Ws"):
        _close(getattr(A, name).numpy(), np.asarray(getattr(JA, name)),
               PROD_TOL, name)
    _close(A.materialize().numpy(),
           np.asarray(jax.vmap(lambda a: a.materialize())(JA)), PROD_TOL,
           "materialize")
    for name, a, b in zip(("H", "g", "A", "lb", "ub", "lbA", "ubA",
                           "const"), qp, jqp):
        if name != "A":
            assert a.shape == np.shape(b), name
            _close(a.numpy(), np.asarray(b), PROD_TOL, name)
    # the same row set as the dense build (group-major there)
    dense, _ = ltv.build_qp_dynamic(x0, x_ref, track, params, mpc, x_lin,
                                    u_lin)

    def key(A, lo, hi):
        fin = lambda v: np.where(np.isfinite(v), v, 1e30)
        rows = np.concatenate([A, fin(lo)[:, None], fin(hi)[:, None]], 1)
        return rows[np.lexsort(np.round(rows, 6).T)]

    Am = A.materialize().numpy()
    for b in range(B):
        _close(key(Am[b], qp[5][b].numpy(), qp[6][b].numpy()),
               key(dense[2][b].numpy(), dense[5][b].numpy(),
                   dense[6][b].numpy()), 1e-10, f"rows of instance {b}")


@pytest.mark.parametrize("case", ["cold", "warm"])
def test_gen_tick_matches_jax(case, jax_refs, port_setup):
    """The structured dense tick (the GenRows hooks of the IPM: 2-norm
    equilibration, quadform KKT, structured matvecs) against the JAX
    package's; the warm tick is seeded from the JAX solver state."""
    mpc, track, params = port_setup
    x0, x_ref, x_lin, u_lin, x0_w = jax_refs["inputs"]
    warm = None
    if case == "warm":
        warm = interop.ipm_result(jax_refs["cold"]["qp"], dtype=F64,
                                  device="cpu")
        x0 = x0_w
    res = ltv.ltv_mpc_dynamic(_t(x0), _t(x_ref), track, params, mpc,
                              _t(x_lin), _t(u_lin), ipm.F32_OPTS, warm=warm,
                              structured="gen")
    ref = jax_refs[case]
    for name in ("u_opt", "x_opt", "slack"):
        np.testing.assert_allclose(getattr(res, name).numpy(), ref[name],
                                   rtol=0, atol=ATOL, err_msg=name)
    np.testing.assert_allclose(res.fval.numpy(), ref["fval"],
                               rtol=FVAL_RTOL)
    np.testing.assert_array_equal(res.qp.iterations.numpy(),
                                  ref["qp"]["iterations"])


def test_f32_accurate_on_both_assemblies():
    """f32 under F32_ACCURATE (compensated products of the GenRows, the
    delta-form restart) on both assemblies at the production shape against
    a tight f64 solve, with the JAX package's bars: first control < 1e-2
    dense and < 3e-2 structured, mean control < 5e-3.  A retired
    ``structured`` value and per-instance polygon radii raise."""
    R, npts = 25.0, 48
    th = np.linspace(0, 2 * np.pi, npts, endpoint=False)
    circ = track_from_points(R * np.cos(th), R * np.sin(th), n_segments=96,
                             dtype=F64, device="cpu")
    mpc, params = MPC_F32, VehicleParams()
    Nf, dt, v0 = mpc.n_steps, mpc.dt, 8.0
    x_ref = np.zeros((1, Nf, 7))
    v_ref = np.minimum(v0 + 10 * dt * np.arange(1, Nf + 1), 20.0)
    x_ref[0, :, 3] = v_ref
    x_ref[0, :, 0] = np.cumsum(v_ref * dt)
    x_lin = np.zeros((1, Nf, 7))
    x_lin[0, :, 0] = v0 * dt * np.arange(1, Nf + 1)
    x_lin[0, :, 3] = v0
    x0 = np.array([[0.0, 0.12, 0.04, v0, 0.1, 0.05, 0.02]])
    args = (_t(x0), _t(x_ref), circ, params, mpc, _t(x_lin),
            torch.zeros((1, Nf, 2), dtype=F64))
    dense, _ = ltv.build_qp_dynamic(*args)
    gen, _ = ltv.build_qp_dynamic(*args, structured="gen")
    assert dense[2].shape == gen[2].shape == (1, 800, 84)
    truth = ipm.solve_qp(*dense[:7]).x[0].numpy()
    to32 = lambda qp: tuple(q.to(dtype=torch.float32) for q in qp[:7])
    for qp, fc_bar in ((dense, 1e-2), (gen, 3e-2)):
        x = ipm.solve_qp(*to32(qp), ipm.F32_ACCURATE).x[0].double().numpy()
        assert np.all(np.isfinite(x))
        err = np.abs(x[:Nf * 2] - truth[:Nf * 2])
        assert err[0] < fc_bar and err[1] < fc_bar, err[:2]
        assert err.mean() < 5e-3, err.mean()
    with pytest.raises(ValueError, match="StageRows"):
        ltv.build_qp_dynamic(*args, structured=True)
    with pytest.raises(ValueError, match="StageRows"):
        ltv.ltv_mpc_dynamic(*args, structured=True)
    # the Riccati backend ignores ``structured``, as the JAX package's does
    ltv.ltv_mpc_dynamic(*args, ipm.F32_OPTS, structured=True,
                        backend="riccati")
    per_radius = dataclasses.replace(params, ac_max=torch.tensor([9.0],
                                                                 dtype=F64))
    with pytest.raises(ValueError, match="ac_max"):
        ltv.build_qp_dynamic(args[0], args[1], circ, per_radius, mpc,
                             *args[5:], structured="gen")


def test_partly_finite_soft_group_drops_its_side_in_both():
    """A soft group whose lower bounds are finite for only some of its
    rows emits no lower rows at all (the JAX package's behaviour,
    ``mpc/ltv.py:295-300``, mirrored): both packages drop the same side
    and assemble the same rows."""
    rng = np.random.default_rng(5)
    Ng, nx, nu, r = 4, 3, 2, 2
    Ad = 0.3 * rng.standard_normal((Ng, nx, nx)) + np.eye(nx)
    Bd = rng.standard_normal((Ng, nx, nu))
    dd = rng.standard_normal((Ng, nx))
    C = rng.standard_normal((Ng, r, nx))
    D = rng.standard_normal((Ng, r, nu))
    off = rng.standard_normal((Ng, r))
    x0 = rng.standard_normal(nx)
    x_ref = rng.standard_normal((Ng, nx))
    q_diag, r_diag = np.ones(Ng * nx), np.ones(Ng * nu)
    u_lb, u_ub = -np.ones((Ng, nu)), np.ones((Ng, nu))
    static = dict(lb=np.array([-1.0, -np.inf]), ub=np.array([1.0, 2.0]),
                  slack_idx=np.array([0, 0], np.int32),
                  state_rows=np.arange(Ng, dtype=np.int32),
                  ctrl_cols=np.arange(Ng, dtype=np.int32))
    from fsae_mpc_tpu.ops.condense import condense as jcondense
    jbars = jcondense(*(jnp.asarray(a) for a in (Ad, Bd, dd)))
    jgrp = jcons.StageConstraint(C=jnp.asarray(C), D=jnp.asarray(D),
                                 offset_const=jnp.asarray(off), **static)
    jqp = jltv.assemble_condensed_qp(
        *jbars, jnp.asarray(x0), jnp.asarray(x_ref), jnp.asarray(q_diag),
        jnp.asarray(r_diag), [1e3], [jgrp], jnp.asarray(u_lb),
        jnp.asarray(u_ub))
    T = lambda a: _t(a)[None]
    bars = condense(T(Ad), T(Bd), T(dd))
    grp = cons.StageConstraint(C=T(C), D=T(D), offset_const=T(off),
                               **static)
    qp = ltv.assemble_condensed_qp(*bars, T(x0), T(x_ref), _t(q_diag),
                                   _t(r_diag), [1e3], [grp], T(u_lb),
                                   T(u_ub))
    # only the upper side (-sigma) is emitted: Ng * r rows, every lower
    # bound -inf
    A, lbA, ubA = qp[2][0].numpy(), qp[5][0].numpy(), qp[6][0].numpy()
    assert A.shape[0] == np.shape(jqp[2])[0] == Ng * r
    assert np.all(np.isneginf(lbA)) and np.all(np.isneginf(jqp[5]))
    assert np.all(A[:, -1] == -1.0)
    for name, a, b in zip(("H", "g", "A", "lb", "ub", "lbA", "ubA",
                           "const"), qp, jqp):
        a, b = a[0].numpy(), np.asarray(b)
        assert np.array_equal(np.isfinite(a), np.isfinite(b)), name
        fin = np.isfinite(b)
        _close(a[fin], b[fin], PROD_TOL, name)
