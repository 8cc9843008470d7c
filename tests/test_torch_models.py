"""Track, models and stage-QP assembly: PyTorch port against JAX.

f64 on the CPU, fsg2019 with the real vehicle, horizon N = 8, two
instances.  Inputs are made with numpy and handed to both packages; the
JAX side is ONE jitted per-instance function (compiled once, run per
instance) that returns everything compared here.  The constraint groups
on their own are compared in ``test_torch_constraints.py``.

Tolerance 1e-10: both sides evaluate the same closed-form f64 expressions
(the spline fit is the same numpy code); they differ only in the order of
a few sums (jacfwd tangent batching, einsum contraction order) and in the
last bits of transcendental functions, so agreement is to ~1e-13 on O(1)
values and 1e-10 leaves room for the O(1e3) entries (friction-polygon
rows scaled by the tyre force).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import vmap

from fsae_mpc_tpu import config as jconfig
from fsae_mpc_tpu.models import curvilinear as jcm
from fsae_mpc_tpu.models import integrators as jint
from fsae_mpc_tpu.mpc import ltv as jltv
from fsae_mpc_tpu.track import load_track as jload_track

from fsae_mpc_tpu_torch import interop
from fsae_mpc_tpu_torch.config import MPC_F32, VehicleParams
from fsae_mpc_tpu_torch.models import curvilinear as cm
from fsae_mpc_tpu_torch.models import integrators
from fsae_mpc_tpu_torch.mpc import ltv
from fsae_mpc_tpu_torch.track import load_track

N = 8
B = 2
F64 = torch.float64
TOL = 1e-10
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def _inputs(mpc, seed=0):
    rng = np.random.default_rng(seed)
    t = mpc.dt * np.arange(1, N + 1)
    x_lin = np.zeros((B, N, 7))
    x_lin[:, :, 0] = 8.0 * t + rng.uniform(0.0, 150.0, (B, 1))
    x_lin[:, :, 1] = rng.uniform(-0.3, 0.3, (B, N))
    x_lin[:, :, 2] = rng.uniform(-0.1, 0.1, (B, N))
    x_lin[:, :, 3] = rng.uniform(6.0, 12.0, (B, N))
    x_lin[:, :, 4] = rng.uniform(-0.5, 0.5, (B, N))
    x_lin[:, :, 5] = rng.uniform(-0.4, 0.4, (B, N))
    x_lin[:, :, 6] = rng.uniform(-0.2, 0.2, (B, N))
    u_lin = np.stack([rng.uniform(-3.0, 3.0, (B, N)),
                      rng.uniform(-0.3, 0.3, (B, N))], -1)
    x0 = x_lin[:, 0] - 0.05 * rng.standard_normal((B, 7))
    x_ref = np.zeros((B, N, 7))
    x_ref[:, :, 3] = 10.0
    x_ref[:, :, 0] = x0[:, 0:1] + 10.0 * t
    s_query = rng.uniform(-50.0, 400.0, 200)       # wraps both ways
    return x0, x_ref, x_lin, u_lin, s_query


@pytest.fixture(scope="module")
def ref():
    mpc_j = dataclasses.replace(jconfig.MPC_F32, n_steps=N)
    track_j, _ = jload_track("data/fsg2019.csv", dtype=jnp.float64)
    params_j = jconfig.VehicleParams()
    x0, x_ref, x_lin, u_lin, s_query = _inputs(mpc_j)

    f = lambda x, u: jcm.f_curv_dyn(x, u, track_j, params_j)
    f_only = lambda x, u: jcm.f_curv_dyn_only(x, u, track_j, params_j)

    def one(x0, x_ref, x_lin, u_lin, s_query):
        fx, fcr = jax.vmap(f)(x_lin, u_lin)
        qp, const = jltv.build_stage_qp_dynamic(
            x0, x_ref, track_j, params_j, mpc_j, x_lin, u_lin)
        return dict(
            kappa=track_j.curvature(s_query),
            f=fx, fcr=fcr,
            rk4=jax.vmap(lambda x, u: jint.rk4_step(f_only, x, u,
                                                    mpc_j.dt))(x_lin, u_lin),
            qp={f.name: getattr(qp, f.name) for f in dataclasses.fields(qp)},
            const=const)

    args = [jnp.asarray(a, jnp.float64) for a in (x0, x_ref, x_lin, u_lin)]
    fn = jax.jit(one).lower(*[a[0] for a in args],
                            jnp.asarray(s_query)).compile(
        compiler_options=FAST_COMPILE)
    outs = [jax.tree_util.tree_map(np.asarray,
                                   fn(*[a[b] for a in args],
                                      jnp.asarray(s_query)))
            for b in range(B)]
    stacked = jax.tree_util.tree_map(lambda *v: np.stack(v), *outs)
    stacked["kappa"] = outs[0]["kappa"]
    return dict(out=stacked, track=track_j,
                inputs=(x0, x_ref, x_lin, u_lin, s_query))


@pytest.fixture(scope="module")
def port():
    mpc = dataclasses.replace(MPC_F32, n_steps=N)
    track, _ = load_track("data/fsg2019.csv", dtype=F64, device="cpu")
    return mpc, track, VehicleParams()


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=F64)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol,
                               atol=tol)


def test_spline_fit_and_curvature(ref, port):
    _, track, _ = port
    tj = ref["track"]
    for name in ("px", "py", "dl", "L"):
        _close(getattr(track, name).numpy(), np.asarray(getattr(tj, name)),
               1e-12)
    s_query = ref["inputs"][4]
    _close(track.curvature(_t(s_query)).numpy(), ref["out"]["kappa"])
    # the interop route gives the same track
    t2 = interop.track(np.asarray(tj.px), np.asarray(tj.py),
                       np.asarray(tj.dl), np.asarray(tj.L), device="cpu")
    _close(t2.curvature(_t(s_query)).numpy(), ref["out"]["kappa"])


def test_dynamics_and_rk4(ref, port):
    mpc, track, params = port
    _, _, x_lin, u_lin, _ = ref["inputs"]
    f = lambda x, u: cm.f_curv_dyn(x, u, track, params)
    fx, fcr = vmap(vmap(f))(_t(x_lin), _t(u_lin))
    _close(fx.numpy(), ref["out"]["f"])
    _close(fcr.numpy(), ref["out"]["fcr"])
    f_only = lambda x, u: cm.f_curv_dyn_only(x, u, track, params)
    rk4 = vmap(vmap(lambda x, u: integrators.rk4_step(f_only, x, u, mpc.dt)))
    _close(rk4(_t(x_lin), _t(u_lin)).numpy(), ref["out"]["rk4"])


def test_linearize_discrete(ref, port):
    mpc, track, params = port
    _, _, x_lin, u_lin, _ = ref["inputs"]
    f_only = lambda x, u: cm.f_curv_dyn_only(x, u, track, params)
    step = lambda x, u: integrators.rk4_step(f_only, x, u, mpc.dt)
    Ad, Bd, dd = integrators.linearize_discrete(step, _t(x_lin), _t(u_lin))
    q = ref["out"]["qp"]
    _close(Ad.numpy(), q["Ad"])
    _close(Bd.numpy(), q["Bd"])
    _close(dd.numpy(), q["dd"])


def test_build_stage_qp_dynamic(ref, port):
    mpc, track, params = port
    x0, x_ref, x_lin, u_lin, _ = ref["inputs"]
    qp, const = ltv.build_stage_qp_dynamic(
        _t(x0), _t(x_ref), track, params, mpc, _t(x_lin), _t(u_lin))
    q = ref["out"]["qp"]
    for f in dataclasses.fields(qp):
        _close(getattr(qp, f.name).numpy(), q[f.name])
    _close(const.numpy(), ref["out"]["const"])
