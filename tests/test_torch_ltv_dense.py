"""The dense condensed LTV-MPC tick: PyTorch port against the JAX package.

Whole-tick parity of ``ltv_mpc_dynamic(backend="dense")`` (linearise,
condense, assemble the condensed QP, dense IPM, state rollout) in f64 on
the CPU, on fsg2019 with the real vehicle, at N=8 and a batch of three
instances with different initial states, under ``F32_OPTS``: cold, and a
warm tick a fifth of a metre further along the same linearisation seeded
from the JAX solver state through ``interop``.  Inputs are made with numpy
and handed to both packages; each JAX tick is compiled once, per instance
(cheaper to trace than its vmap), the two side by side.  Tolerances as in
``test_torch_ltv_slice.py`` (same algorithm, another summation order):
controls, states and slacks to 1e-6 absolute, the objective to 1e-8
relative.

The dense and Riccati ticks of the port solve the same QP: their tight f64
solutions agree to solver precision, with the JAX package's own bars for
that comparison (``tests/test_riccati.py``).
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
from fsae_mpc_tpu.track import load_track as jload_track

from fsae_mpc_tpu_torch import interop
from fsae_mpc_tpu_torch.config import MPC_F32, VehicleParams
from fsae_mpc_tpu_torch.mpc import ltv
from fsae_mpc_tpu_torch.ops import ipm
from fsae_mpc_tpu_torch.track import load_track

N = 8
B = 3
F64 = torch.float64
ATOL = 1e-6
FVAL_RTOL = 1e-8
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
    x0_w = x0.copy()
    x0_w[:, 0] += 0.2
    return x0, x_ref, x_lin, u_lin, x0_w


@pytest.fixture(scope="module")
def jax_results():
    mpc_j = dataclasses.replace(jconfig.MPC_F32, n_steps=N)
    track_j, _ = jload_track("data/fsg2019.csv", dtype=jnp.float64)
    params_j = jconfig.VehicleParams()
    x0, x_ref, x_lin, u_lin, x0_w = _inputs(mpc_j)

    def tick(x0, x_ref, x_lin, u_lin, warm=None):
        return jltv.ltv_mpc_dynamic(x0, x_ref, track_j, params_j, mpc_j,
                                    x_lin, u_lin, jipm.F32_OPTS, warm=warm)

    args = [jnp.asarray(a, jnp.float64)
            for a in (x0, x_ref, x_lin, u_lin, x0_w)]
    one = [a[0] for a in args[:4]]
    res_s = jax.eval_shape(tick, *one)
    lowered = [jax.jit(tick).lower(*one),
               jax.jit(tick).lower(*one, res_s.qp)]
    with ThreadPoolExecutor(len(lowered)) as pool:
        cold_c, warm_c = pool.map(
            lambda low: low.compile(compiler_options=FAST_COMPILE), lowered)

    per_case = {"cold": [], "warm": []}
    for b in range(B):
        a = [v[b] for v in args]
        cold = cold_c(*a[:4])
        per_case["cold"].append(cold)
        per_case["warm"].append(warm_c(a[4], *a[1:4], cold.qp))
    results = {}
    for k, rs in per_case.items():
        stack = lambda get: np.stack([np.asarray(get(r)) for r in rs])
        results[k] = dict(
            u_opt=stack(lambda r: r.u_opt), x_opt=stack(lambda r: r.x_opt),
            slack=stack(lambda r: r.slack), fval=stack(lambda r: r.fval),
            qp={f.name: stack(lambda r: getattr(r.qp, f.name))
                for f in dataclasses.fields(jipm.IpmResult)})
    results["inputs"] = (x0, x_ref, x_lin, u_lin, x0_w)
    return results


@pytest.fixture(scope="module")
def port_setup():
    mpc = dataclasses.replace(MPC_F32, n_steps=N)
    track, _ = load_track("data/fsg2019.csv", dtype=F64, device="cpu")
    return mpc, track, VehicleParams()


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=F64)


@pytest.mark.parametrize("case", ["cold", "warm"])
def test_dense_tick_matches_jax(case, jax_results, port_setup):
    mpc, track, params = port_setup
    x0, x_ref, x_lin, u_lin, x0_w = jax_results["inputs"]
    warm = None
    if case == "warm":
        warm = interop.ipm_result(jax_results["cold"]["qp"], dtype=F64,
                                  device="cpu")
        x0 = x0_w
    res = ltv.ltv_mpc_dynamic(_t(x0), _t(x_ref), track, params, mpc,
                              _t(x_lin), _t(u_lin), ipm.F32_OPTS, warm=warm)
    ref = jax_results[case]
    for name in ("u_opt", "x_opt", "slack"):
        np.testing.assert_allclose(getattr(res, name).numpy(), ref[name],
                                   rtol=0, atol=ATOL, err_msg=name)
    np.testing.assert_allclose(res.fval.numpy(), ref["fval"],
                               rtol=FVAL_RTOL)
    np.testing.assert_array_equal(res.qp.iterations.numpy(),
                                  ref["qp"]["iterations"])


def test_dense_and_riccati_ticks_share_the_minimiser(jax_results,
                                                     port_setup):
    """Both backends of the port solve the same QP (tight f64 solves)."""
    mpc, track, params = port_setup
    x0, x_ref, x_lin, u_lin, _ = (_t(a) for a in jax_results["inputs"])
    opts = ipm.IpmOptions(max_iters=60)
    rd = ltv.ltv_mpc_dynamic(x0, x_ref, track, params, mpc, x_lin, u_lin,
                             opts)
    rr = ltv.ltv_mpc_dynamic(x0, x_ref, track, params, mpc, x_lin, u_lin,
                             opts, backend="riccati")
    np.testing.assert_allclose(rr.u_opt[:, 0].numpy(),
                               rd.u_opt[:, 0].numpy(), atol=1e-4)
    assert float((rr.u_opt - rd.u_opt).abs().max()) < 5e-3
    np.testing.assert_allclose(rr.fval.numpy(), rd.fval.numpy(), rtol=1e-5)
