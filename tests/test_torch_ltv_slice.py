"""The warm dynamic LTV-MPC tick: PyTorch port against the JAX package.

Whole-tick parity in f64 on the CPU (where the port runs the plain
versions of its CUDA kernels), on fsg2019 with the real vehicle, at a
short horizon and a batch of three instances with different initial
states: cold under ``F32_OPTS``, a warm tick seeded from the JAX
solver state through ``interop``, cold under ``F32_PRODUCTION``, and an
adaptive solve (``IpmOptions(max_iters=60, tol=1e-8)``: the instances stop
after different iteration counts, as in the f64 accuracy reference).
Inputs are made with numpy and handed to both packages; each JAX function
is compiled once, per instance (cheaper to trace than its vmap), and run
for each instance.  That a batched tick equals one-instance ticks is
checked in ``test_torch_isolation.py``.

Tolerance: both sides run the same f64 algorithm with the same fixed
iteration budget; they differ only in summation order (einsum
contraction order, batched vs per-instance reductions), ~1e-15 relative
per operation.  The IPM's Newton steps amplify that by the KKT
conditioning (the complementarity diagonals reach 1e14 in f64), so
controls, states and slacks are held to 1e-6 absolute and the objective
to 1e-8 relative.
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fsae_mpc_tpu import config as jconfig
from fsae_mpc_tpu.mpc import ltv as jltv
from fsae_mpc_tpu.ops import ipm as jipm
from fsae_mpc_tpu.ops import riccati as jriccati
from fsae_mpc_tpu.track import load_track as jload_track

from fsae_mpc_tpu_torch import interop
from fsae_mpc_tpu_torch.config import MPC_F32, VehicleParams
from fsae_mpc_tpu_torch.mpc import ltv
from fsae_mpc_tpu_torch.ops import ipm

N = 8
B = 3
F64 = torch.float64
ATOL = 1e-6
FVAL_RTOL = 1e-8
# XLA:CPU options for the one reference compile: optimisation off, which
# changes nothing of the f64 semantics and a quarter of the compile time
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


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
    # the warm tick: a quarter metre further along the same linearisation
    x0_w = x0.copy()
    x0_w[:, 0] += 0.2
    return x0, x_ref, x_lin, u_lin, x0_w


@pytest.fixture(scope="module")
def jax_results():
    mpc_j = dataclasses.replace(jconfig.MPC_F32, n_steps=N)
    track_j, _ = jload_track("data/fsg2019.csv", dtype=jnp.float64)
    params_j = jconfig.VehicleParams()
    x0, x_ref, x_lin, u_lin, x0_w = _inputs(mpc_j)

    # ltv_mpc_dynamic_riccati is build_stage_qp_dynamic + solve_stage_qp;
    # the ticks share one linearisation, which is traced once.  Each solve
    # is its own executable so that XLA:CPU (one thread per compile)
    # compiles them side by side.
    def build(x0, x_ref, x_lin, u_lin):
        return jltv.build_stage_qp_dynamic(x0, x_ref, track_j, params_j,
                                           mpc_j, x_lin, u_lin)

    def solve(opts):
        return lambda qp, x0_, warm=None: jriccati.solve_stage_qp(
            dataclasses.replace(qp, x0=x0_), opts, warm=warm)

    solves = {"cold": solve(jipm.F32_OPTS), "warm": solve(jipm.F32_OPTS),
              "prod": solve(jipm.F32_PRODUCTION),
              "adaptive": solve(jipm.IpmOptions(max_iters=60, tol=1e-8))}
    args = [jnp.asarray(a, jnp.float64)
            for a in (x0, x_ref, x_lin, u_lin, x0_w)]
    one = [a[0] for a in args]
    qp_s, _ = jax.eval_shape(build, *one[:4])
    res_s = jax.eval_shape(solves["cold"], qp_s, one[0])
    lowered = [jax.jit(build).lower(*one[:4])] + [
        jax.jit(fn).lower(qp_s, one[0], *([res_s] if k == "warm" else []))
        for k, fn in solves.items()]
    with ThreadPoolExecutor(len(lowered)) as pool:
        compiled = list(pool.map(
            lambda low: low.compile(compiler_options=FAST_COMPILE),
            lowered))
    build_c, sol_c = compiled[0], dict(zip(solves, compiled[1:]))

    per_case = {k: [] for k in solves}
    for b in range(B):
        qp, const = build_c(*[a[b] for a in args[:4]])
        out = {k: sol_c[k](qp, args[0][b]) for k in ("cold", "prod",
                                                      "adaptive")}
        out["warm"] = sol_c["warm"](qp, args[4][b], out["cold"])
        for k, r in out.items():
            per_case[k].append((r, const))
    results = {}
    for k, rs in per_case.items():
        stack = lambda get: np.stack([np.asarray(get(r, c)) for r, c in rs])
        results[k] = dict(
            u_opt=stack(lambda r, c: r.u), x_opt=stack(lambda r, c: r.x),
            slack=stack(lambda r, c: r.s),
            fval=stack(lambda r, c: r.objective + c),
            qp={f.name: stack(lambda r, c: getattr(r, f.name))
                for f in dataclasses.fields(rs[0][0])})
    results["inputs"] = (x0, x_ref, x_lin, u_lin, x0_w)
    return results


@pytest.fixture(scope="module")
def port_setup():
    from fsae_mpc_tpu_torch.track import load_track
    mpc = dataclasses.replace(MPC_F32, n_steps=N)
    track, _ = load_track("data/fsg2019.csv", dtype=F64, device="cpu")
    return mpc, track, VehicleParams()


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=F64)


def _assert_tick(res, ref):
    np.testing.assert_allclose(res.u_opt.numpy(), ref["u_opt"], rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(res.x_opt.numpy(), ref["x_opt"], rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(res.slack.numpy(), ref["slack"], rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(res.fval.numpy(), ref["fval"],
                               rtol=FVAL_RTOL)
    assert np.all(np.isfinite(res.u_opt.numpy()))


@pytest.mark.parametrize("case", ["cold", "warm", "prod", "adaptive"])
def test_tick_matches_jax(case, jax_results, port_setup):
    mpc, track, params = port_setup
    x0, x_ref, x_lin, u_lin, x0_w = jax_results["inputs"]
    if case == "warm":
        warm = interop.stage_ipm_result(jax_results["cold"]["qp"],
                                         dtype=F64, device="cpu")
        res = ltv.ltv_mpc_dynamic_riccati(
            _t(x0_w), _t(x_ref), track, params, mpc, _t(x_lin), _t(u_lin),
            ipm.F32_OPTS, warm=warm)
    else:
        opts = {"cold": ipm.F32_OPTS, "prod": ipm.F32_PRODUCTION,
                "adaptive": ipm.IpmOptions(max_iters=60, tol=1e-8)}[case]
        res = ltv.ltv_mpc_dynamic_riccati(
            _t(x0), _t(x_ref), track, params, mpc, _t(x_lin), _t(u_lin),
            opts)
    _assert_tick(res, jax_results[case])
    np.testing.assert_array_equal(res.qp.iterations.numpy(),
                                  jax_results[case]["qp"]["iterations"])
