"""Constraint groups: PyTorch port against the JAX package.

f64 on the CPU with the real vehicle, horizon N = 8, two instances of
linearisation points made with numpy.  The JAX side is ONE jitted
per-instance function returning the rows of all three groups of the
dynamic controller (compiled once, run per instance); the port builds
each group on the whole batch.

Tolerance 1e-10, as in ``test_torch_models.py``: the same closed-form
f64 tyre expressions differentiated forward on both sides; 1e-10 leaves
room for the O(1e3) friction-polygon rows.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fsae_mpc_tpu import config as jconfig
from fsae_mpc_tpu.mpc import constraints as jcons

from fsae_mpc_tpu_torch.config import MPC_F32, VehicleParams
from fsae_mpc_tpu_torch.mpc import constraints as cons


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
F64 = torch.float64
TOL = 1e-10
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}
GROUPS = ["state_box", "slip", "polygon"]
BOX = ([3, 6], np.array([0.0, -0.4]), np.array([np.inf, 0.4]),
       np.array([-1, -1]))


def _inputs(seed=1):
    rng = np.random.default_rng(seed)
    x_lin = np.zeros((B, N, 7))
    x_lin[:, :, 0] = rng.uniform(0.0, 300.0, (B, N))
    x_lin[:, :, 1] = rng.uniform(-0.3, 0.3, (B, N))
    x_lin[:, :, 2] = rng.uniform(-0.1, 0.1, (B, N))
    x_lin[:, :, 3] = rng.uniform(6.0, 12.0, (B, N))
    x_lin[:, :, 4] = rng.uniform(-0.5, 0.5, (B, N))
    x_lin[:, :, 5] = rng.uniform(-0.4, 0.4, (B, N))
    x_lin[:, :, 6] = rng.uniform(-0.2, 0.2, (B, N))
    u_lin = np.stack([rng.uniform(-3.0, 3.0, (B, N)),
                      rng.uniform(-0.3, 0.3, (B, N))], -1)
    return x_lin, u_lin


@pytest.fixture(scope="module")
def ref():
    mpc_j = dataclasses.replace(jconfig.MPC_F32, n_steps=N)
    params_j = jconfig.VehicleParams()
    x_lin, u_lin = _inputs()

    def one(x_lin, u_lin):
        groups = [
            jcons.state_box_group(*BOX, x_lin, u_lin),
            jcons.dynamic_slip_group(x_lin, u_lin, mpc_j, params_j, 1, 2),
            jcons.friction_polygon_group(x_lin, u_lin, mpc_j, params_j, 3)]
        return [(g.C, g.D, g.offset_const) for g in groups]

    args = [jnp.asarray(a, jnp.float64) for a in (x_lin, u_lin)]
    fn = jax.jit(one).lower(*[a[0] for a in args]).compile(
        compiler_options=FAST_COMPILE)
    outs = [jax.tree_util.tree_map(np.asarray, fn(*[a[b] for a in args]))
            for b in range(B)]
    return (jax.tree_util.tree_map(lambda *v: np.stack(v), *outs),
            (x_lin, u_lin))


@pytest.mark.parametrize("group", GROUPS)
def test_constraint_groups(group, ref):
    out, (x_lin, u_lin) = ref
    mpc, params = dataclasses.replace(MPC_F32, n_steps=N), VehicleParams()
    xl, ul = (torch.as_tensor(a, dtype=F64) for a in (x_lin, u_lin))
    g = {"state_box": lambda: cons.state_box_group(*BOX, xl, ul),
         "slip": lambda: cons.dynamic_slip_group(xl, ul, mpc, params, 1, 2),
         "polygon": lambda: cons.friction_polygon_group(xl, ul, mpc, params,
                                                        3)}[group]()
    for got, want in zip((g.C, g.D, g.offset_const),
                         out[GROUPS.index(group)]):
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
