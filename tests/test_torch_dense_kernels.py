"""Condense and dense Cholesky: the port's plain versions against the JAX
package.

On the CPU the port's kernel wrappers route to their plain PyTorch
versions; here they are held, in f64, against

  * condense (K5): ``ops/condense.py:condense`` under ``jax.vmap`` and the
    Pallas TPU kernel ``condense_lanes`` in interpret mode (as
    ``tests/test_pallas.py`` runs it on the CPU), at N=8, B=3, nu=2 and
    nx=7 (dynamic) and nx=5 (kinematic); ``rollout`` against the JAX
    ``rollout`` under ``vmap``;
  * Cholesky factor and solve (K6/K7): ``factor_lanes``/``solve_lanes`` in
    interpret mode and ``jnp.linalg.cholesky``/``cho_solve``, at n=12,
    B=3, with one indefinite instance that must come out NaN while its
    neighbours stay finite.  The lower triangles are compared (the Pallas
    kernel leaves its upper triangle undefined).

Tolerance 1e-10 (relative and absolute): the same f64 recursions in
another summation order on well-conditioned data.
"""

import jax
import jax.numpy as jnp
import jax.scipy.linalg
import numpy as np
import pytest
import torch

from fsae_mpc_tpu.ops.condense import condense as jcondense
from fsae_mpc_tpu.ops.condense import rollout as jrollout
from fsae_mpc_tpu.ops.pallas import chol as jpchol
from fsae_mpc_tpu.ops.pallas import condense as jpcondense

from fsae_mpc_tpu_torch.ops import condense as tcondense
from fsae_mpc_tpu_torch.ops.kernels import chol as kchol
from fsae_mpc_tpu_torch.ops.kernels import condense as kcondense


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are tiny: one intra-op thread keeps this file's
    PyTorch work off the cores that the suite's other files share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


B, N, NU, NCHOL = 3, 8, 2, 12
TOL = 1e-10
F64 = torch.float64
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def _stage_inputs(nx, seed):
    rng = np.random.default_rng(seed)
    return dict(Ad=np.eye(nx) + 0.05 * rng.standard_normal((B, N, nx, nx)),
                Bd=0.05 * rng.standard_normal((B, N, nx, NU)),
                dd=0.05 * rng.standard_normal((B, N, nx)),
                x0=rng.standard_normal((B, nx)),
                u=rng.standard_normal((B, N, NU)))


def _chol_inputs(seed=3):
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((B, NCHOL, NCHOL))
    K = M @ np.swapaxes(M, -1, -2) + NCHOL * np.eye(NCHOL)
    K[1] -= 60.0 * np.eye(NCHOL)                 # indefinite instance
    return K, rng.standard_normal((B, NCHOL))


def _references(stages, K, rhs):
    out = {"condense": {}}
    for nx, d in stages.items():
        out["condense"][nx] = dict(
            scan=jax.vmap(jcondense)(d["Ad"], d["Bd"], d["dd"]),
            lanes=jpcondense.condense_lanes(d["Ad"], d["Bd"], d["dd"]),
            rollout=jax.vmap(jrollout)(d["Ad"], d["Bd"], d["dd"], d["x0"],
                                       d["u"]))
    L_lapack = jax.vmap(jnp.linalg.cholesky)(K)
    L_lanes = jpchol.factor_lanes(K)
    # the solves on the factor of the SPD instances' own K (the indefinite
    # instance's NaN factor gives NaN either way)
    out["chol"] = dict(
        L_lapack=L_lapack, L_lanes=L_lanes,
        x_lapack=jax.vmap(lambda L, b: jax.scipy.linalg.cho_solve(
            (L, True), b))(L_lapack, rhs),
        x_lanes=jpchol.solve_lanes(L_lanes, rhs))
    return out


@pytest.fixture(scope="module")
def ref():
    """The JAX references as one program (one trace and one compile, in
    place of a compile of every operation run eagerly)."""
    stages = {nx: {k: jnp.asarray(v)
                   for k, v in _stage_inputs(nx, nx).items()}
              for nx in (7, 5)}
    K, rhs = (jnp.asarray(a) for a in _chol_inputs())
    out = jax.jit(_references).lower(stages, K, rhs).compile(
        compiler_options=FAST_COMPILE)(stages, K, rhs)
    return jax.tree_util.tree_map(np.asarray, out)


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=F64)


@pytest.mark.parametrize("nx", [7, 5])
def test_condense_and_rollout_match_jax(nx, ref):
    d = {k: _t(v) for k, v in _stage_inputs(nx, nx).items()}
    out = kcondense.condense(d["Ad"], d["Bd"], d["dd"])  # CPU: plain version
    jref = ref["condense"][nx]
    for name, o, s, ln in zip(("A_bar", "B_bar", "d_bar"), out,
                              jref["scan"], jref["lanes"]):
        np.testing.assert_allclose(o.numpy(), s, rtol=TOL, atol=TOL,
                                   err_msg=f"{name} vs vmap(condense)")
        np.testing.assert_allclose(o.numpy(), ln, rtol=TOL, atol=TOL,
                                   err_msg=f"{name} vs condense_lanes")
    xs = tcondense.rollout(d["Ad"], d["Bd"], d["dd"], d["x0"], d["u"])
    np.testing.assert_allclose(xs.numpy(), jref["rollout"], rtol=TOL,
                               atol=TOL)
    # the rollout through the condensed matrices gives the same states
    u_flat = d["u"].reshape(B, -1)
    x_pred = (torch.einsum("bnij,bj->bni", out[0], d["x0"])
              + torch.einsum("bnij,bj->bni", out[1], u_flat) + out[2])
    np.testing.assert_allclose(x_pred.numpy(), xs.numpy(), rtol=TOL,
                               atol=TOL)


def test_chol_factor_matches_jax_and_poisons_one_instance(ref):
    K, _ = _chol_inputs()
    L = kchol.factor(_t(K)).numpy()                      # CPU: plain version
    ok = [0, 2]
    np.testing.assert_allclose(np.tril(L[ok]), ref["chol"]["L_lapack"][ok],
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(np.tril(L[ok]),
                               np.tril(ref["chol"]["L_lanes"][ok]),
                               rtol=TOL, atol=TOL)
    assert np.all(np.triu(L[ok], 1) == 0.0)
    # the indefinite instance is NaN (as jnp.linalg.cholesky on the CPU, and
    # as the Pallas kernel from its first non-positive pivot on)
    low = np.tril_indices(NCHOL)
    assert np.all(np.isnan(L[1][low]))
    assert np.all(np.isnan(ref["chol"]["L_lapack"][1][low]))
    assert not np.all(np.isfinite(np.tril(ref["chol"]["L_lanes"][1])))


def test_chol_solve_matches_jax(ref):
    K, rhs = _chol_inputs()
    L = kchol.factor(_t(K))
    x = kchol.solve(L, _t(rhs)).numpy()                  # CPU: plain version
    ok = [0, 2]
    np.testing.assert_allclose(x[ok], ref["chol"]["x_lapack"][ok], rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(x[ok], ref["chol"]["x_lanes"][ok], rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(np.einsum("bij,bj->bi", K[ok], x[ok]),
                               rhs[ok], rtol=TOL, atol=TOL)
    assert np.all(np.isnan(x[1]))
    assert np.all(np.isnan(ref["chol"]["x_lanes"][1]))
