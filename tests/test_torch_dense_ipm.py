"""The dense condensed IPM: PyTorch port against the JAX package.

``solve_qp`` parity in f64 on the CPU (where the port factors and solves
with the plain versions of its Cholesky kernels), on the condensed QPs of
a short-horizon fsg2019 tick (N=8, so n = 16 controls + 4 slacks and
m = 160 rows) for three instances with different initial states.  The QP
data is built once by the port and handed, as numpy, to both packages.
Three option sets, each JAX solve compiled once per instance (cheaper to
trace than its vmap), all side by side:

  * ``F32_OPTS`` cold, then warm on the next tick's QP, seeded from the
    JAX solver state through ``interop.ipm_result``;
  * ``F32_PRODUCTION`` (two delta-form restart rounds, each with variable
    scaling, about the first solve);
  * ``F32_ACCURATE`` with ``polish=2, correctors=1`` (Jacobi-scaled KKT
    solves with refinement, compensated residuals, Gondzio correctors, a
    restart round and the active-set polish).

Tolerance: the same f64 algorithm with the same fixed iteration budget in
another summation order (~1e-15 relative per operation), amplified by the
KKT conditioning (complementarity diagonals up to 1e14 in f64) and, under
the restart presets, by the merit gate: the primal solution is held to
1e-6 absolute and the objective to 1e-8 relative, as in
``test_torch_ltv_slice.py``.
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fsae_mpc_tpu.ops import ipm as jipm

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


N, B = 8, 3
F64 = torch.float64
ATOL = 1e-6
OBJ_RTOL = 1e-8
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}
CASES = {
    "opts_cold": (ipm.F32_OPTS, jipm.F32_OPTS),
    "opts_warm": (ipm.F32_OPTS, jipm.F32_OPTS),
    "production": (ipm.F32_PRODUCTION, jipm.F32_PRODUCTION),
    "accurate": (dataclasses.replace(ipm.F32_ACCURATE, polish=2,
                                     correctors=1),
                 dataclasses.replace(jipm.F32_ACCURATE, polish=2,
                                     correctors=1)),
}


def _qps():
    """The condensed QPs (H, g, A, lb, ub, lbA, ubA) of two consecutive
    ticks, as numpy: the second a fifth of a metre further along the same
    linearisation."""
    mpc = dataclasses.replace(MPC_F32, n_steps=N)
    track, _ = load_track("data/fsg2019.csv", dtype=F64, device="cpu")
    t = mpc.dt * torch.arange(1, N + 1, dtype=F64)
    x0 = torch.zeros((B, 7), dtype=F64)
    x0[:, 0] = torch.tensor([3.0, 41.0, 97.0])
    x0[:, 1] = torch.tensor([0.1, -0.15, 0.05])
    x0[:, 3] = torch.tensor([8.0, 7.0, 9.0])
    x_lin = torch.zeros((B, N, 7), dtype=F64)
    x_lin[:, :, 0] = 8.0 * t
    x_lin[:, :, 3] = 8.0
    v = torch.clamp_max(x0[:, 3:4] + 10.0 * t, 20.0)
    x_ref = torch.zeros((B, N, 7), dtype=F64)
    x_ref[:, :, 3] = v
    x_ref[:, :, 0] = x0[:, 0:1] + torch.cumsum(v * mpc.dt, 1)
    u_lin = torch.zeros((B, N, 2), dtype=F64)
    x0_w = x0.clone()
    x0_w[:, 0] += 0.2
    out = []
    for xs in (x0, x0_w):
        qp, _ = ltv.build_qp_dynamic(xs, x_ref, track, VehicleParams(), mpc,
                                     x_lin, u_lin)
        out.append([a.numpy() for a in qp[:7]])
    return out


@pytest.fixture(scope="module")
def jax_results():
    qp_c, qp_w = _qps()

    def solve(opts, warm):
        if warm:
            return lambda *a: jipm.solve_qp(*a[:7], opts, warm=a[7])
        return lambda *a: jipm.solve_qp(*a, opts)

    one = [jnp.asarray(a[0]) for a in qp_c]
    # each program is compiled on a worker thread while the next one is
    # traced; the cold solve's trace gives the warm start's shapes
    compile_ = lambda low: low.compile(compiler_options=FAST_COMPILE)
    with ThreadPoolExecutor(len(CASES)) as pool:
        cold_t = jax.jit(solve(CASES["opts_cold"][1], False)).trace(*one)
        futs = {"opts_cold": pool.submit(compile_, cold_t.lower())}
        for k, (_, jo) in CASES.items():
            if k != "opts_cold":
                futs[k] = pool.submit(compile_, jax.jit(
                    solve(jo, k == "opts_warm")).trace(
                        *one, *([cold_t.out_info] if k == "opts_warm"
                                else [])).lower())
        compiled = {k: f.result() for k, f in futs.items()}
    per_case = {k: [] for k in CASES}
    for b in range(B):
        qc = [jnp.asarray(a[b]) for a in qp_c]
        qw = [jnp.asarray(a[b]) for a in qp_w]
        for k in ("opts_cold", "production", "accurate"):
            per_case[k].append(compiled[k](*qc))
        per_case["opts_warm"].append(
            compiled["opts_warm"](*qw, per_case["opts_cold"][b]))
    results = {k: {f.name: np.stack([np.asarray(getattr(r, f.name))
                                     for r in rs])
                   for f in dataclasses.fields(jipm.IpmResult)}
               for k, rs in per_case.items()}
    results["qps"] = (qp_c, qp_w)
    return results


@pytest.mark.parametrize("case", list(CASES))
def test_solve_qp_matches_jax(case, jax_results):
    qp_c, qp_w = jax_results["qps"]
    opts = CASES[case][0]
    warm = None
    if case == "opts_warm":
        warm = interop.ipm_result(jax_results["opts_cold"], dtype=F64,
                                  device="cpu")
    qp = [torch.as_tensor(a) for a in (qp_w if warm is not None else qp_c)]
    res = ipm.solve_qp(*qp, opts, warm=warm)
    ref = jax_results[case]
    np.testing.assert_allclose(res.x.numpy(), ref["x"], rtol=0, atol=ATOL)
    np.testing.assert_allclose(res.objective.numpy(), ref["objective"],
                               rtol=OBJ_RTOL)
    np.testing.assert_array_equal(res.iterations.numpy(), ref["iterations"])
    assert np.all(np.isfinite(res.x.numpy()))
