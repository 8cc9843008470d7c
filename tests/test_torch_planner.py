"""The minimum-time planners, the s -> t resampling of a plan and the
closed loop's raceline reference: the PyTorch port against the JAX
package.

In f64 on the CPU, on the seed's 30 m circle (``tests/test_planner.py``)
at 16 nodes:

  * ``minimum_time_planner_kinematic`` (seg_len 4: four segments of four
    nodes) and ``minimum_time_planner_dynamic`` (full multiple shooting)
    for a few SQP iterations, each run by both packages on their own
    track fit of the same points;
  * ``obtain_reference`` batched over positions s0 (before the start,
    inside the lap, past its end) against one JAX call per position, on
    the JAX package's dynamic plan;
  * ``simulate`` with ``reference="raceline"`` at a batch of two (N=8,
    ``F32_OPTS``) on that plan, carried into the port by
    ``interop.planner_result``, against the JAX sim (rolling starts, as
    ``test_torch_closed_loop.py``).  The kinematic model on the dense
    backend: the reference path is the same for every controller, and
    the JAX package traces this loop in 4.5 s where the dynamic Riccati
    one takes 8-11 s on one core (the card runs the dynamic Riccati loop,
    ``chip_smoke.py`` phase 7).

The JAX references are ONE program, traced once and compiled on a worker
thread while the port runs.

Tolerances.  A planner subproblem's QP is not determined beyond ~1e-4:
its IPM stops at ``max_iters`` (50) with a dual residual ~2e-4, so the
last digits of its inputs move its answer.  The JAX package's own jitted
and eager runs of one planner differ by up to 7.4e-4 in y_opt (of 17-21),
3.2e-4 in u_opt, 2.0e-5 in t_node, 2.0e-5 s in lap_time and 9e-6 in
defect_norm after four iterations; the port lies within 9.4e-4, 2.6e-4,
2.1e-5, 4.8e-5 s and 2.0e-5 of the jitted run (measured).  The planners
are held to 5e-3, 2e-3, 2e-4, 5e-4 s and 2e-4, and the dynamic planner's
slacks (~2e-9) to 1e-9 absolute.  Everything else runs the same f64
algorithm in another summation order: the resampled reference to 1e-10,
the closed loop's every float field to 1e-9 relative and absolute (as
``test_torch_closed_loop.py``), its booleans and counts exactly.
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fsae_mpc_tpu import config as jconfig
from fsae_mpc_tpu import planner as jplanner
from fsae_mpc_tpu.models import transforms as jtransforms
from fsae_mpc_tpu.ops import ipm as jipm
from fsae_mpc_tpu.sim import closed_loop as jsim
from fsae_mpc_tpu.track import track_from_points as jtrack_from_points

from fsae_mpc_tpu_torch import interop, planner
from fsae_mpc_tpu_torch.config import VehicleParams
from fsae_mpc_tpu_torch.sim import closed_loop as sim
from fsae_mpc_tpu_torch.track import track_from_points


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are tiny: one intra-op thread keeps this file's
    PyTorch work off the cores that the suite's other files share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


R_CIRCLE, N_POINTS, N_SEG = 30.0, 48, 64
N_NODES = 16
ITERS = 4
N = 8
TICKS = 4
S0 = (-3.0, 0.0, 17.3, 101.9, 250.0)          # the resampling positions
SIM_STARTS = ((0.0, 4.0), (3.0, 6.0))          # (s on the centreline, speed)
F64 = torch.float64
PLAN_TOL = {"y_opt": 5e-3, "u_opt": 2e-3, "t_node": 2e-4, "lap_time": 5e-4,
            "defect_norm": 2e-4, "slack": 1e-9}
REF_TOL = 1e-10
SIM_TOL = 1e-9
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}
EXACT = ("converged", "active", "solver_iters", "lap_done", "max_iters")
KINDS = ("kinematic", "dynamic")


def _circle():
    th = np.linspace(0, 2 * np.pi, N_POINTS, endpoint=False)
    return R_CIRCLE * np.cos(th), R_CIRCLE * np.sin(th)


def _jax_cfg():
    return jsim.SimConfig(
        model="kinematic", qp_backend="dense", reference="raceline",
        n_ticks=TICKS, mpc=dataclasses.replace(jconfig.MPC_F32, n_steps=N),
        ipm=jipm.F32_OPTS)


@pytest.fixture(scope="module")
def jax_ref():
    track = jtrack_from_points(*_circle(), n_segments=N_SEG,
                               dtype=jnp.float64)
    params = jconfig.VehicleParams()
    cfg = _jax_cfg()
    x_sim = np.zeros((2, 7))
    for i, (s, v) in enumerate(SIM_STARTS):
        px, py, th = jtransforms.curvilinear_to_cartesian(
            jnp.asarray(s), jnp.asarray(0.0), jnp.asarray(0.0), track)
        x_sim[i, :4] = [float(px), float(py), float(th), v]

    def program(s0, x_sim):
        plans = {
            "kinematic": jplanner.minimum_time_planner_kinematic(
                track, params, n_nodes=N_NODES, iters=ITERS),
            "dynamic": jplanner.minimum_time_planner_dynamic(
                track, params, n_nodes=N_NODES, iters=ITERS)}
        plan = plans["dynamic"]
        ds = track.L / N_NODES
        ref = jax.vmap(lambda s: jplanner.obtain_reference(
            plan.y_opt, plan.u_opt, plan.t_node, ds, s, cfg.mpc.dt, N))(s0)
        out = jax.vmap(lambda xi: jsim.simulate(track, params, cfg, xi,
                                                plan=plan))(x_sim)
        return plans, ref, out

    args = (jnp.asarray(S0), jnp.asarray(x_sim))
    low = jax.jit(program).lower(*args)
    pool = ThreadPoolExecutor(1)
    fut = pool.submit(lambda: jax.tree_util.tree_map(np.asarray, low.compile(
        compiler_options=FAST_COMPILE)(*args)))
    yield x_sim, fut
    pool.shutdown()


@pytest.fixture(scope="module")
def port_plans(jax_ref):
    """The port's plans on its own fit of the circle (run while the JAX
    program compiles)."""
    track = track_from_points(*_circle(), n_segments=N_SEG, dtype=F64,
                              device="cpu")
    return track, {
        kind: getattr(planner, f"minimum_time_planner_{kind}")(
            track, VehicleParams(), n_nodes=N_NODES, iters=ITERS)
        for kind in KINDS}


def _fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def _jax_plan(jax_ref):
    return interop.planner_result(
        _fields(jax_ref[1].result()[0]["dynamic"]), device="cpu")


@pytest.mark.parametrize("kind", KINDS)
def test_planner_matches_jax(kind, jax_ref, port_plans):
    """The plan's node states, controls and times, its lap time, defect
    and slacks."""
    got = port_plans[1][kind]
    ref = jax_ref[1].result()[0][kind]
    assert tuple(got.y_opt.shape) == (N_NODES, 4 if kind == "kinematic"
                                      else 6)
    assert got.y_opt.dtype == F64
    for f_, tol in PLAN_TOL.items():
        a, b = getattr(got, f_).numpy(), np.asarray(getattr(ref, f_))
        assert a.shape == b.shape, f_
        np.testing.assert_allclose(a, b, rtol=0, atol=tol, err_msg=f_)
    assert abs(float(got.lap_time) - float(got.t_node.sum())) < 1e-12
    assert np.isfinite(float(got.merit))


def test_obtain_reference_matches_jax(jax_ref):
    """One batched call against one JAX call per position."""
    plan = _jax_plan(jax_ref)
    track = track_from_points(*_circle(), n_segments=N_SEG, dtype=F64,
                              device="cpu")
    got = planner.obtain_reference(plan.y_opt, plan.u_opt, plan.t_node,
                                   track.L / N_NODES,
                                   torch.tensor(S0, dtype=F64),
                                   _jax_cfg().mpc.dt, N)
    ref = jax_ref[1].result()[1]
    assert tuple(got.shape) == (len(S0), N, 7)
    np.testing.assert_allclose(got.numpy(), ref, rtol=REF_TOL, atol=REF_TOL)
    # s increases from each s0, unwrapped across the lap's end
    assert (np.diff(got[:, :, 0].numpy(), axis=1) > 0).all()


def test_raceline_closed_loop_matches_jax(jax_ref, port_plans):
    """``simulate`` tracking the JAX plan: every trace and summary field,
    per instance; a raceline loop without a plan is refused."""
    track = port_plans[0]
    cfg = interop.sim_config(dataclasses.asdict(_jax_cfg()))
    got = sim.simulate(track, VehicleParams(), cfg,
                       torch.tensor(jax_ref[0], dtype=F64),
                       plan=_jax_plan(jax_ref))
    ref = interop.sim_outputs(_fields(jax_ref[1].result()[2]), dtype=F64,
                              device="cpu")
    for f_ in dataclasses.fields(sim.SimOutputs):
        a, b = getattr(got, f_.name), getattr(ref, f_.name)
        assert a.shape == b.shape, f_.name
        if f_.name in EXACT:
            np.testing.assert_array_equal(a.numpy(), b.numpy(),
                                          err_msg=f_.name)
        else:
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=SIM_TOL,
                                       atol=SIM_TOL, err_msg=f_.name)
    with pytest.raises(ValueError, match="plan"):
        sim.simulate(track, VehicleParams(), cfg,
                     torch.tensor(jax_ref[0], dtype=F64))
