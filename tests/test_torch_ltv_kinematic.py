"""The kinematic LTV-MPC tick: PyTorch port against the JAX package.

Whole-tick parity of ``ltv_mpc_kinematic`` (RK2 linearisation of the
curvilinear kinematic model, box, track and lateral-acceleration rows,
one slack) on both backends -- dense (condense, the condensed QP of
n = 2N+1 variables, dense IPM, rollout) and Riccati (the stage QP, nx=5,
ns=1) -- in f64 on the CPU, on fsg2019 with the real vehicle, at N=8 and
a batch of three instances with different initial states, under
``F32_OPTS``: cold, and a warm tick a fifth of a metre further along the
same linearisation seeded from the JAX solver state through ``interop``.
Inputs are made with numpy and handed to both packages; each JAX tick is
compiled once, per instance.  Tolerances as in
``test_torch_ltv_slice.py`` (same algorithm, another summation order):
controls, states and slacks to 1e-6 absolute, the objective to 1e-8
relative, iteration counts exactly.
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
ATOL = 1e-6
FVAL_RTOL = 1e-8
BACKENDS = ("dense", "riccati")
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}
WARM_RESULT = {"dense": interop.ipm_result,
               "riccati": interop.stage_ipm_result}


def _inputs(mpc):
    t = mpc.dt * np.arange(1, N + 1)
    x_lin = np.zeros((B, N, 5))
    x_lin[:, :, 0] = 8.0 * t
    x_lin[:, :, 3] = 8.0
    u_lin = np.zeros((B, N, 2))
    x0 = np.zeros((B, 5))
    x0[:, 0] = [3.0, 41.0, 97.0]
    x0[:, 1] = [0.1, -0.15, 0.05]
    x0[:, 2] = [0.02, -0.01, 0.0]
    x0[:, 3] = [8.0, 7.0, 9.0]
    x0[:, 4] = [0.0, 0.05, -0.03]
    v = np.minimum(x0[:, 3:4] + 10.0 * mpc.dt * np.arange(1, N + 1), 20.0)
    x_ref = np.zeros((B, N, 5))
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
    args = [jnp.asarray(a, jnp.float64)
            for a in (x0, x_ref, x_lin, u_lin, x0_w)]

    def ticks(backend):
        """The cold tick and the warm tick seeded from it, traced as one
        function (one trace and one compile per backend)."""
        def run(x0, x_ref, x_lin, u_lin, x0_w):
            tick = lambda x0, warm=None: jltv.ltv_mpc_kinematic(
                x0, x_ref, track_j, params_j, mpc_j, x_lin, u_lin,
                jipm.F32_OPTS, warm=warm, backend=backend)
            cold = tick(x0)
            return cold, tick(x0_w, cold.qp)
        return run

    one = [a[0] for a in args]
    # each backend's program is compiled on a worker thread while the next
    # one is traced
    compile_ = lambda low: low.compile(compiler_options=FAST_COMPILE)
    with ThreadPoolExecutor(len(BACKENDS)) as pool:
        futs = {b: pool.submit(compile_, jax.jit(ticks(b)).lower(*one))
                for b in BACKENDS}
        compiled = {b: f.result() for b, f in futs.items()}

    results = {}
    for backend in BACKENDS:
        runs = [compiled[backend](*[v[b] for v in args]) for b in range(B)]
        for i, k in enumerate(("cold", "warm")):
            stack = lambda get: np.stack([np.asarray(get(r[i]))
                                          for r in runs])
            results[backend, k] = dict(
                u_opt=stack(lambda r: r.u_opt),
                x_opt=stack(lambda r: r.x_opt),
                slack=stack(lambda r: r.slack), fval=stack(lambda r: r.fval),
                qp={f.name: stack(lambda r: getattr(r.qp, f.name))
                    for f in dataclasses.fields(runs[0][0].qp)})
    return results, (x0, x_ref, x_lin, u_lin, x0_w)


@pytest.fixture(scope="module")
def port_setup():
    mpc = dataclasses.replace(MPC_F32, n_steps=N)
    track, _ = load_track("data/fsg2019.csv", dtype=F64, device="cpu")
    return mpc, track, VehicleParams()


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=F64)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("case", ["cold", "warm"])
def test_kinematic_tick_matches_jax(case, backend, jax_results, port_setup):
    mpc, track, params = port_setup
    results, (x0, x_ref, x_lin, u_lin, x0_w) = jax_results
    warm = None
    if case == "warm":
        warm = WARM_RESULT[backend](results[backend, "cold"]["qp"],
                                    dtype=F64, device="cpu")
        x0 = x0_w
    res = ltv.ltv_mpc_kinematic(_t(x0), _t(x_ref), track, params, mpc,
                                _t(x_lin), _t(u_lin), ipm.F32_OPTS,
                                warm=warm, backend=backend)
    ref = results[backend, case]
    for name in ("u_opt", "x_opt", "slack"):
        np.testing.assert_allclose(getattr(res, name).numpy(), ref[name],
                                   rtol=0, atol=ATOL, err_msg=name)
    np.testing.assert_allclose(res.fval.numpy(), ref["fval"],
                               rtol=FVAL_RTOL)
    np.testing.assert_array_equal(res.qp.iterations.numpy(),
                                  ref["qp"]["iterations"])


def test_kinematic_backends_share_the_minimiser(jax_results, port_setup):
    """Both backends solve the same QP (tight f64 solves): the dense one
    has 2N+1 variables, the Riccati one nx=5 and ns=1.  An unported
    condenser raises."""
    mpc, track, params = port_setup
    x0, x_ref, x_lin, u_lin, _ = (_t(a) for a in jax_results[1])
    opts = ipm.IpmOptions(max_iters=60)
    rd = ltv.ltv_mpc_kinematic(x0, x_ref, track, params, mpc, x_lin, u_lin,
                               opts)
    rr = ltv.ltv_mpc_kinematic(x0, x_ref, track, params, mpc, x_lin, u_lin,
                               opts, backend="riccati")
    assert rd.qp.x.shape == (B, 2 * N + 1)
    assert rr.qp.x.shape == (B, N, 5) and rr.slack.shape == (B, 1)
    np.testing.assert_allclose(rr.u_opt[:, 0].numpy(),
                               rd.u_opt[:, 0].numpy(), atol=1e-4)
    np.testing.assert_allclose(rr.fval.numpy(), rd.fval.numpy(), rtol=1e-5)
    with pytest.raises(ValueError, match="dnc"):
        ltv.ltv_mpc_kinematic(x0, x_ref, track, params, mpc, x_lin, u_lin,
                              opts, condense="dnc")
