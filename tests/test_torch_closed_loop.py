"""The closed-loop lap simulator: PyTorch port against the JAX package.

``simulate`` at a batch of two laps, N=8, 10 ticks, on fsg2019 with
``MPC_F32`` and ``F32_OPTS``, in f64 on the CPU, for kinematic/dense and
dynamic/Riccati, against ``fsae_mpc_tpu.sim.closed_loop.simulate``
(compiled once per configuration, run per instance), every trace and
summary field per instance.  The presets' own solver paths are held
against the JAX package in the tick tests; the card runs the sim under
``F32_ACCURATE`` and ``F32_PRODUCTION`` (``chip_smoke.py`` phase 4).

Instance 0 starts on the origin at 4 m/s.  From rest the plant is stiff
(the slip angles' sensitivity to the lateral velocities is 1/v_eps =
100 s/m there, and a 5 ms RK6 substep lies far outside its stability
region): it amplifies a last-digit difference ~1e7-fold within 20
substeps, and the kinematic/dense loop's states then part by up to
3e-2 m within five ticks (measured under ``F32_ACCURATE``): the same
dynamics in another summation order.  A rolling start keeps the
comparison at solver precision.

Instance 1 starts at 5 m/s on the centreline, 1.5 m before a finish line
placed at ``S1 + 1.5``: a ``Track`` whose ``L`` (read by the sim only
for ``done |= s >= L``; the spline wraps at ``M * dl``) is moved there,
on both sides.  The real finish cannot serve: the first projection is
warm-started at the initial guess's s = 0.0125 m, so a car placed at
``L - 1.5`` projects to s = -1.5 and needs a whole lap to reach L.  So
instance 1's lap ends inside the window and instance 0's does not, which
exercises the per-instance ``done``, the freezing and ``lap_time``.

Tolerances.  Both sides run the same f64 algorithm; they differ in
summation order, ~1e-16 relative per operation, which the IPM amplifies
by its KKT conditioning and the loop carries into the next tick's
linearisation and warm start.  Measured over these 10 ticks: states
7e-14, controls 3e-14, lateral offsets 1e-15, objectives 8e-14 and rear
tyre forces 5e-14 relative, the residual floors (``qp_pres``,
``qp_mu``) 5e-14 absolute.  Every float field is held to 1e-9 relative
and 1e-9 absolute (four orders of headroom for another BLAS or CPU), and
every boolean and count (``converged``, ``active``, ``solver_iters``,
``lap_done``, ``max_iters``) exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fsae_mpc_tpu import config as jconfig
from fsae_mpc_tpu.models import transforms as jtransforms
from fsae_mpc_tpu.ops import ipm as jipm
from fsae_mpc_tpu.sim import closed_loop as jsim
from fsae_mpc_tpu.track import load_track as jload_track

from fsae_mpc_tpu_torch import interop
from fsae_mpc_tpu_torch.config import VehicleParams
from fsae_mpc_tpu_torch.sim import closed_loop as sim
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
TICKS = 10
V0 = 4.0                      # instance 0's rolling start at the origin
S1 = 5.0                      # instance 1's start on the centreline
FINISH = S1 + 1.5             # the moved finish line
F64 = torch.float64
TOL = 1e-9
CONFIGS = {"kinematic-dense": ("kinematic", "dense"),
           "dynamic-riccati": ("dynamic", "riccati")}
EXACT = ("converged", "active", "solver_iters", "lap_done", "max_iters")


def _jax_cfg(name):
    model, backend = CONFIGS[name]
    return jsim.SimConfig(
        model=model, qp_backend=backend, n_ticks=TICKS,
        mpc=dataclasses.replace(jconfig.MPC_F32, n_steps=N),
        ipm=jipm.F32_OPTS)


@pytest.fixture(scope="module")
def jax_runs():
    track, _ = jload_track("data/fsg2019.csv", dtype=jnp.float64)
    track = dataclasses.replace(track, L=jnp.asarray(FINISH, jnp.float64))
    x, y, th = jtransforms.curvilinear_to_cartesian(
        jnp.asarray(S1), jnp.asarray(0.0), jnp.asarray(0.0), track)
    x_init = np.zeros((2, 7))
    x_init[0, 3] = V0
    x_init[1, :4] = [float(x), float(y), float(th), 5.0]
    params = jconfig.VehicleParams()
    runs = {}
    for name in CONFIGS:
        cfg = _jax_cfg(name)
        fn = jax.jit(lambda xi: jsim.simulate(track, params, cfg, xi))
        outs = [fn(jnp.asarray(xi)) for xi in x_init]
        runs[name] = {f.name: np.stack([np.asarray(getattr(o, f.name))
                                        for o in outs])
                      for f in dataclasses.fields(jsim.SimOutputs)}
    return x_init, runs


@pytest.fixture(scope="module")
def port_runs(jax_runs):
    x_init, runs = jax_runs
    track, _ = load_track("data/fsg2019.csv", dtype=F64, device="cpu")
    track = dataclasses.replace(track, L=torch.tensor(FINISH, dtype=F64))
    out = {}
    for name in CONFIGS:
        cfg = interop.sim_config(dataclasses.asdict(_jax_cfg(name)))
        out[name] = sim.simulate(track, VehicleParams(), cfg,
                                 torch.tensor(x_init, dtype=F64))
    return track, out, x_init


@pytest.mark.parametrize("name", list(CONFIGS))
def test_simulate_matches_jax(name, jax_runs, port_runs):
    """Every trace and summary field, per instance."""
    ref = interop.sim_outputs(jax_runs[1][name], dtype=F64, device="cpu")
    got = port_runs[1][name]
    for f in dataclasses.fields(sim.SimOutputs):
        a, b = getattr(got, f.name), getattr(ref, f.name)
        assert a.shape == b.shape, f.name
        if f.name in EXACT:
            np.testing.assert_array_equal(a.numpy(), b.numpy(),
                                          err_msg=f.name)
        else:
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=TOL,
                                       atol=TOL, err_msg=f.name)


def test_finished_lap_is_frozen(port_runs):
    """Instance 1 crosses the line inside the window and is frozen from
    that tick on; instance 0 runs every tick."""
    for name, out in port_runs[1].items():
        act = out.active.numpy()
        assert act[0].all(), name
        end = int(np.argmin(act[1]))
        assert 0 < end < TICKS and not act[1, end:].any(), name
        xs = out.x_history[1].numpy()
        assert (xs[end:] == xs[end - 1]).all(), name
        assert out.lap_done.tolist() == [False, True], name
        np.testing.assert_allclose(out.lap_time.numpy(),
                                   [TICKS * 0.05, end * 0.05], rtol=1e-12)


def test_simulate_timed_stops_early(port_runs):
    """Host-stepped, on instance 1 alone: it stops at the tick the lap is
    done, and its traces equal ``simulate``'s on the ticks it ran."""
    track, outs, x_init = port_runs
    name = "kinematic-dense"
    full = outs[name]
    cfg = interop.sim_config(dataclasses.asdict(_jax_cfg(name)))
    out, timing = sim.simulate_timed(track, VehicleParams(), cfg,
                                     torch.tensor(x_init[1:], dtype=F64))
    end = int(np.argmin(full.active[1].numpy()))
    assert timing["n_ticks_timed"] == end + 1 < TICKS
    assert timing["budget_s"] == cfg.mpc.dt
    assert (timing["tick_time_max_s"] >= timing["tick_time_p99_s"]
            >= timing["tick_time_median_s"] > 0.0)
    for f in ("x_history", "u_history", "n_history", "obj_history",
              "solver_iters", "active"):
        np.testing.assert_allclose(
            getattr(out, f)[0].double().numpy(),
            getattr(full, f)[1, :end + 1].double().numpy(), rtol=1e-9,
            atol=1e-9, err_msg=f)
    assert bool(out.lap_done[0])


def test_unported_modes_raise(port_runs):
    """The NMPC modes and the raceline reference raise before any work."""
    for change in ({"mode": "ms-nmpc"}, {"mode": "c-nmpc"},
                   {"reference": "raceline"}):
        cfg = dataclasses.replace(sim.SimConfig(n_ticks=1), **change)
        for run in (sim.simulate, sim.simulate_timed):
            with pytest.raises(ValueError, match="not ported"):
                run(port_runs[0], VehicleParams(), cfg)
