"""Scenario batching: per-instance vehicles and tracks, the PyTorch port
against the JAX package and against itself.

The pod-scale layout (the JAX package's ``scripts/pod_scale.py`` and
``tests/test_parallel.py::test_multitrack_vmap``): fsg2019, fso2020 and
fss2019, fitted at 100 segments, stacked into one batched ``Track``, and
one perturbed vehicle per track.  The vehicles are ``jax.random``'s draws
of the JAX package's ``perturbed_params`` (``jax.random`` and torch draw
different streams), carried across by ``interop.vehicle_params``.  All in
f64 on the CPU.

  * the dynamic QP build of one tick at B = 3 against ``jax.vmap`` of
    the JAX package's single-instance ``build_qp_dynamic`` over (track,
    vehicle) pairs: every output to 1e-10 (the same arithmetic in another
    summation order, ~1e-16 relative per operation);
  * batched equals single in the port: one tick of the batch against the
    same tick of each instance alone (its own track, its vehicle as
    floats), on both LTV backends and the multiple-shooting Riccati NMPC,
    to 1e-12 (measured: bitwise on the Riccati paths, ~1e-15 dense);
  * the slice: ``simulate`` of the batch, kinematic/dense LTV, N = 8, 8
    ticks, against ``jax.jit(jax.vmap(simulate))``, every field within
    ``TOL`` = 1e-9 as in ``test_torch_closed_loop.py``, and the same batch
    split into one shard per track.  The cars start rolling at 4 m/s on
    the origin (from rest the plant amplifies a last-digit difference
    ~1e7-fold, that file's docstring);
  * ``simulate_chunked`` equals ``simulate`` bitwise, and so does a run
    resumed from a chunk's checkpoint.

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
from fsae_mpc_tpu.mpc import ltv as jltv
from fsae_mpc_tpu.ops import ipm as jipm
from fsae_mpc_tpu.sim import batch as jbatch
from fsae_mpc_tpu.sim import closed_loop as jsim
from fsae_mpc_tpu.track import load_track as jload_track

from fsae_mpc_tpu_torch import interop
from fsae_mpc_tpu_torch.config import MPC_F32, VehicleParams
from fsae_mpc_tpu_torch.mpc import ltv, sqp
from fsae_mpc_tpu_torch.ops import ipm
from fsae_mpc_tpu_torch.parallel import make_mesh
from fsae_mpc_tpu_torch.sim import checkpoint
from fsae_mpc_tpu_torch.sim import closed_loop as sim
from fsae_mpc_tpu_torch.sim.batch import perturbed_params, simulate_batch
from fsae_mpc_tpu_torch.track import load_track, stack_tracks


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are tiny: one intra-op thread keeps this file's
    PyTorch work off the cores that the suite's other files share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TRACKS = ("fsg2019", "fso2020", "fss2019")
B = len(TRACKS)
N = 8
TICKS = 8
V0 = 4.0
F64 = torch.float64
TOL = 1e-9
BUILD_TOL = 1e-10
SINGLE_TOL = 1e-12
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}
EXACT = ("converged", "active", "solver_iters", "lap_done", "max_iters")
MPC = dataclasses.replace(MPC_F32, n_steps=N)


def _tick_inputs():
    """One tick's data per instance (numpy): spread along each track at
    7-9 m/s, linearised along a straight constant-speed guess."""
    t = MPC.dt * np.arange(1, N + 1)
    x_lin = np.zeros((B, N, 7))
    x_lin[:, :, 0] = 8.0 * t
    x_lin[:, :, 3] = 8.0
    x0 = np.zeros((B, 7))
    x0[:, 0] = [3.0, 41.0, 97.0]
    x0[:, 1] = [0.1, -0.15, 0.05]
    x0[:, 3] = [8.0, 7.0, 9.0]
    v = np.minimum(x0[:, 3:4] + 10.0 * t, 20.0)
    x_ref = np.zeros((B, N, 7))
    x_ref[:, :, 3] = v
    x_ref[:, :, 0] = x0[:, 0:1] + np.cumsum(v * MPC.dt, axis=1)
    return x0, x_ref, x_lin, np.zeros((B, N, 2))


def _x_init():
    x = np.zeros((B, 7))
    x[:, 3] = V0
    return x


def _sim_cfg(model="kinematic", ticks=TICKS):
    return jsim.SimConfig(model=model, n_ticks=ticks,
                          mpc=dataclasses.replace(jconfig.MPC_F32,
                                                  n_steps=N),
                          ipm=jipm.F32_OPTS)


@pytest.fixture(scope="module")
def jax_refs():
    """The stacked tracks, the drawn vehicles (numpy) and, on worker
    threads, the JAX package's QP build and laps of the batch."""
    tracks = [jload_track(f"data/{n}.csv", dtype=jnp.float64)[0]
              for n in TRACKS]
    tb = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *tracks)
    params = jax.tree_util.tree_map(
        lambda x: jnp.asarray(x, jnp.float64),
        jbatch.perturbed_params(jconfig.VehicleParams(), jax.random.key(7),
                                B))
    mpc = dataclasses.replace(jconfig.MPC_F32, n_steps=N)
    x0, x_ref, x_lin, u_lin = (jnp.asarray(a) for a in _tick_inputs())
    cfg = _sim_cfg()

    def compiled(low):
        return low.compile(compiler_options=FAST_COMPILE)

    build = jax.jit(jax.vmap(lambda t, p, a, r, xl, ul: jltv.build_qp_dynamic(
        a, r, t, p, mpc, xl, ul))).lower(tb, params, x0, x_ref, x_lin, u_lin)
    laps = jax.jit(jax.vmap(lambda t, p, xi: jsim.simulate(
        t, p, cfg, xi))).lower(tb, params, jnp.asarray(_x_init()))
    pool = ThreadPoolExecutor(2)
    futs = {
        "build": pool.submit(lambda: compiled(build)(
            tb, params, x0, x_ref, x_lin, u_lin)),
        "laps": pool.submit(lambda: compiled(laps)(
            tb, params, jnp.asarray(_x_init())))}
    fields = {f.name: np.asarray(getattr(params, f.name))
              for f in dataclasses.fields(jconfig.VehicleParams)}
    yield fields, futs
    pool.shutdown()


@pytest.fixture(scope="module")
def batch(jax_refs):
    """The port's batched track and vehicles (the JAX draws) and each
    instance's own track, in f64 on the CPU."""
    singles = [load_track(f"data/{n}.csv", dtype=F64, device="cpu")[0]
               for n in TRACKS]
    params = interop.vehicle_params(jax_refs[0], device="cpu")
    return stack_tracks(singles), params, singles


def _instance_params(params, b):
    return VehicleParams(**{f.name: float(getattr(params, f.name)[b])
                            for f in dataclasses.fields(VehicleParams)})


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=F64)


def test_qp_build_per_instance_matches_jax(jax_refs, batch):
    """The dynamic QP of a batch of (track, vehicle) pairs, condensed and
    with its linearisation, against the JAX package's per-instance build
    vmapped over the pairs."""
    track, params, _ = batch
    assert track.batched and params.m.shape == (B,)
    assert len({float(v) for v in params.m}) == B
    x0, x_ref, x_lin, u_lin = (_t(a) for a in _tick_inputs())
    qp, lin = ltv.build_qp_dynamic(x0, x_ref, track, params, MPC, x_lin,
                                   u_lin)
    (jqp, jlin) = jax_refs[1]["build"].result()
    names = ("H", "g", "A", "lb", "ub", "lbA", "ubA", "const", "Ad", "Bd",
             "dd")
    for name, a, b in zip(names, qp + lin, tuple(jqp) + tuple(jlin)):
        b = np.asarray(b)
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a.numpy(), b, rtol=BUILD_TOL,
                                   atol=BUILD_TOL, err_msg=name)


@pytest.mark.parametrize("path", ["dense", "riccati", "ms-nmpc"])
def test_batched_equals_single(path, batch):
    """Per-instance vehicles and tracks change nothing but each instance's
    data: a tick of the batch equals the tick of each instance alone."""
    track, params, singles = batch
    x0, x_ref, x_lin, u_lin = (_t(a) for a in _tick_inputs())

    def tick(tr, pr, *a):
        if path == "ms-nmpc":
            return sqp.ms_nmpc_dynamic(a[0], a[1], tr, pr, MPC, a[2], a[3],
                                       ipm.F32_OPTS, backend="riccati")
        return ltv.ltv_mpc_dynamic(a[0], a[1], tr, pr, MPC, a[2], a[3],
                                   ipm.F32_OPTS, backend=path)

    whole = tick(track, params, x0, x_ref, x_lin, u_lin)
    for b in range(B):
        one = tick(singles[b], _instance_params(params, b),
                   *(v[b:b + 1] for v in (x0, x_ref, x_lin, u_lin)))
        for f in ("u_opt", "x_opt", "slack", "fval"):
            np.testing.assert_allclose(
                getattr(one, f).numpy()[0], getattr(whole, f).numpy()[b],
                rtol=SINGLE_TOL, atol=SINGLE_TOL, err_msg=f"{path} {f} {b}")


def test_pod_slice_matches_jax(jax_refs, batch):
    """``simulate_batch`` over the stacked tracks and drawn vehicles:
    every trace and summary field of every instance against the JAX
    package's laps, vmapped over (track, vehicle) pairs."""
    track, params, _ = batch
    cfg = interop.sim_config(dataclasses.asdict(_sim_cfg()))
    got = simulate_batch(track, params, cfg, _t(_x_init()))
    ref = interop.sim_outputs(
        {k: np.asarray(v) for k, v in vars(jax_refs[1]["laps"].result())
         .items()}, dtype=F64, device="cpu")
    assert got.x_history.shape == (B, TICKS, 7)
    for f in dataclasses.fields(sim.SimOutputs):
        a, b = getattr(got, f.name), getattr(ref, f.name)
        assert a.shape == b.shape, f.name
        if f.name in EXACT:
            np.testing.assert_array_equal(a.numpy(), b.numpy(),
                                          err_msg=f.name)
        else:
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=TOL,
                                       atol=TOL, err_msg=f.name)
    # the tracks differ, so do the laps
    x = got.x_history.numpy()
    assert np.abs(x[0] - x[1]).max() > 1e-3
    # one shard per track
    sharded = simulate_batch(track, params, cfg, _t(_x_init()),
                             mesh=make_mesh(devices=["cpu"] * B))
    np.testing.assert_allclose(sharded.x_history.numpy(), x, rtol=TOL,
                               atol=TOL)


def test_chunked_and_resumed_equal_simulate(batch, tmp_path):
    """``simulate_chunked`` (7 ticks in chunks of 3: three chunks, the
    last trimmed) through checkpoints, and a run resumed from chunk 0's
    checkpoint, equal ``simulate`` bitwise; what the JAX package refuses
    raises."""
    track, params, singles = batch
    cfg = interop.sim_config(dataclasses.asdict(_sim_cfg(ticks=7)))
    x_init = _t(_x_init())
    full = sim.simulate(track, params, cfg, x_init)
    chunked = sim.simulate_chunked(track, params, cfg, chunk_ticks=3,
                                   x_init=x_init, ckpt_dir=str(tmp_path))
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "chunk_00000.pt", "chunk_00001.pt", "chunk_00002.pt"]
    like = sim.init_chunked(track, params, cfg, x_init)
    carry = checkpoint.restore(checkpoint.chunk_path(str(tmp_path), 0),
                               like)
    assert carry.ticks == 3 and carry.state[5].z_rows.shape[0] == B
    resumed = sim.simulate_chunked(track, params, cfg, chunk_ticks=3,
                                   carry=carry, start_tick=3)
    for out in (chunked, resumed):
        for f in dataclasses.fields(sim.SimOutputs):
            a, b = getattr(out, f.name), getattr(full, f.name)
            assert a.dtype == b.dtype, f.name
            torch.testing.assert_close(a, b, rtol=0, atol=0, msg=f.name)
    with pytest.raises(ValueError, match="start_tick"):
        sim.simulate_chunked(track, params, cfg, 3, carry=carry,
                             start_tick=6)
    raceline = dataclasses.replace(cfg, reference="raceline")
    with pytest.raises(ValueError, match="planner result"):
        sim.simulate_chunked(track, params, raceline)
    with pytest.raises(ValueError, match="batch of tracks"):
        sim.simulate(track, params, raceline, x_init, plan=object())
    # the port's own draws: m, Iz, pD per vehicle, the rest repeated
    p = perturbed_params(VehicleParams(), torch.Generator().manual_seed(0),
                         5, dtype=F64, device="cpu")
    assert p.m.shape == (5,) and len(set(p.pD.tolist())) == 5
    assert p.lr.tolist() == [VehicleParams().lr] * 5
    with pytest.raises(ValueError, match="segment counts"):
        stack_tracks([singles[0], load_track(
            "data/fso2020.csv", n_segments=50, dtype=F64, device="cpu")])
