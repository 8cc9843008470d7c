"""The port's scale-out, checkpoint and utility modules on the CPU:
``parallel.mesh``, ``sim.checkpoint``, ``utils.debug``, ``utils.profiling``
and ``utils.viz``.

The mesh is four entries of the CPU (a device may repeat: one card's
batch split into shards).  The sharded solve is held to the unsharded one
at the JAX package's own bar (``tests/test_parallel.py``: 1e-12), and both
to the JAX package's ``solve_qp`` on the same data; the metric reduction
to the JAX package's ``pmean_metrics``.  The file keeps six tests or
fewer (xdist's ``--dist loadfile`` queues files by test count).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fsae_mpc_tpu.ops import ipm as jipm
from fsae_mpc_tpu.parallel import mesh as jmesh

from fsae_mpc_tpu_torch.config import VehicleParams
from fsae_mpc_tpu_torch.ops import ipm, riccati
from fsae_mpc_tpu_torch.parallel import mesh as pm
from fsae_mpc_tpu_torch.sim import checkpoint
from fsae_mpc_tpu_torch.track import load_track
from fsae_mpc_tpu_torch.utils import debug, profiling, viz
from fsae_mpc_tpu_torch.utils import tree as tree_util


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are tiny: one intra-op thread keeps this file's
    PyTorch work off the cores that the suite's other files share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


F64 = torch.float64
MESH = ["cpu"] * 4


def _qp_data():
    """The JAX package's sharded-solve data: 16 strictly convex box- and
    row-constrained QPs of 6 variables and 4 rows."""
    rng = np.random.default_rng(0)
    Bq, n, m = 16, 6, 4
    M = rng.normal(size=(Bq, n, n))
    return (M @ np.swapaxes(M, 1, 2) + n * np.eye(n),
            rng.normal(size=(Bq, n)), rng.normal(size=(Bq, m, n)),
            np.full((Bq, n), -2.0), np.full((Bq, n), 2.0),
            np.full((Bq, m), -1.0), np.full((Bq, m), 1.0))


def _metrics():
    return {"lap": np.arange(8.0), "viol": 2.0 * np.ones(8),
            "done": np.arange(8) % 4 == 0}


@pytest.fixture(scope="module")
def jax_refs():
    qp = [jnp.asarray(a) for a in _qp_data()]
    x = jax.jit(jax.vmap(lambda *a: jipm.solve_qp(*a).x))(*qp)
    jm = jmesh.make_mesh()
    means = jmesh.pmean_metrics(jmesh.shard_batch(
        {k: jnp.asarray(v) for k, v in _metrics().items()}, jm), jm)
    return np.asarray(x), {k: float(v) for k, v in means.items()}


def test_sharded_solve_matches_unsharded(jax_refs):
    """The data-parallel split does not change numerics: the dense IPM on
    four shards of the batch against the whole batch."""
    mesh = pm.make_mesh(devices=MESH)
    assert mesh == [torch.device("cpu")] * 4
    assert pm.make_mesh(2, devices=MESH) == mesh[:2]
    with pytest.raises(ValueError, match="devices"):
        pm.make_mesh(5, devices=MESH)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="no CUDA device"):
            pm.make_mesh()
    pm.initialize_distributed(num_processes=1)       # single process: no-op
    args = tuple(torch.as_tensor(a, dtype=F64) for a in _qp_data())
    fn = lambda *a: ipm.solve_qp(*a).x
    dev = debug.check_shard_determinism(fn, args, mesh)
    assert dev.shape == (16,) and float(dev.max()) < 1e-12
    x = pm.sharded_batch_apply(fn, mesh, args)
    np.testing.assert_allclose(x.numpy(), jax_refs[0], rtol=0, atol=1e-9)
    shards = pm.shard_batch((args[1], VehicleParams()), mesh)
    assert [s[0].shape[0] for s in shards] == [4] * 4
    assert shards[0][1] == VehicleParams()


def test_pmean_metrics(jax_refs):
    """The global mean of per-scenario metrics from per-shard sums,
    booleans as shares, against the JAX package's reduction."""
    mesh = pm.make_mesh(devices=MESH)
    m = {k: torch.as_tensor(v) for k, v in _metrics().items()}
    m["lap"], m["viol"] = m["lap"].to(F64), m["viol"].to(F64)
    out = pm.pmean_metrics(m, mesh)
    for k, v in jax_refs[1].items():
        assert abs(float(out[k]) - v) < 1e-12, k
    assert out["done"].dtype == torch.get_default_dtype()
    assert abs(float(out["lap"]) - 3.5) < 1e-12


def test_assert_finite_and_nan_checking():
    debug.assert_finite({"a": torch.ones(3), "n": 3, "b": (torch.ones(2),)})
    with pytest.raises(FloatingPointError, match=r"\['b.1'\]"):
        debug.assert_finite({"a": torch.ones(3),
                             "b": (torch.ones(2), torch.tensor([1.0,
                                                                np.inf]))})
    x = torch.tensor([1.0, 0.0])
    with debug.nan_checking():
        y = torch.log(x + 1.0)                      # finite: runs
        with pytest.raises(FloatingPointError, match="div"):
            x / x
    assert torch.isfinite(y).all()
    torch.zeros(2) / torch.zeros(2)                 # outside: no check


def test_checkpoint_round_trip(tmp_path):
    """A tree of dataclasses, tuples, dicts, None and numbers through
    ``torch.save`` and ``torch.load``'s default (``weights_only=True``):
    every leaf back, on the device of its counterpart in ``like``."""
    rng = np.random.default_rng(3)
    z = lambda *s: torch.as_tensor(rng.standard_normal(s))
    res = riccati.StageIpmResult(
        u=z(2, 4, 2), x=z(2, 4, 7), s=z(2, 4), lam=z(2, 4, 7),
        z_u=z(2, 4, 2), z_s=z(2, 4), z_rows=z(2, 4, 20),
        iterations=torch.tensor([12, 7], dtype=torch.int32), mu=z(2),
        primal_res=z(2), dual_res=z(2), objective=z(2))
    tree = {"warm": res, "pids": ((z(2), z(2)), (z(2), z(2))),
            "done": torch.tensor([True, False]), "none": None, "tick": 5,
            "view": z(6, 3)[::2]}
    path = checkpoint.save(str(tmp_path / "c" / "tree.pt"), tree)
    assert isinstance(torch.load(path), dict)        # the default loader
    back = checkpoint.restore(path, tree)
    assert back["tick"] == 5 and back["none"] is None
    assert isinstance(back["warm"], riccati.StageIpmResult)
    for (k, a), b in zip(
            tree_util.flatten(tree).items(), tree_util.leaves(back)):
        if torch.is_tensor(a):
            assert a.dtype == b.dtype and torch.equal(a, b), k
    with pytest.raises(ValueError, match="differ"):
        checkpoint.restore(path, {**tree, "extra": z(1)})
    with pytest.raises(ValueError, match="float32"):
        checkpoint.restore(path, {**tree, "view": z(3, 3).float()})
    seen = []
    out = checkpoint.run_chunked(lambda c: (seen.append(c), c + 1)[1], 0, 3,
                                 str(tmp_path / "run"), start_chunk=1)
    assert out == 2 and seen == [0, 1]
    assert torch.load(checkpoint.chunk_path(str(tmp_path / "run"), 2)) == \
        {"": 2}


def test_profiling(tmp_path):
    """Host-clock timing of a CPU result (the caller asked for the CPU),
    the latency summary's keys, and a profiler trace written as JSON."""
    a = torch.ones((64, 64), dtype=F64)
    fn = lambda: a @ a
    assert profiling.time_fn(fn, reps=3) > 0.0
    st = profiling.latency_stats(fn, reps=5)
    assert set(st) == {"mean", "median", "p99", "max"}
    assert st["max"] >= st["p99"] >= st["median"] > 0.0
    timed = profiling.Timed(fn)
    timed()
    timed()
    assert len(timed.samples) == 2
    with profiling.trace(str(tmp_path / "tr")) as prof:
        fn()
    assert (tmp_path / "tr" / "trace.json").stat().st_size > 0
    assert any("mm" in e.key for e in prof.key_averages())


def test_plot_lap_writes_png(tmp_path):
    """The lap overview and the telemetry of instance 1 of a batched
    output, and one tick's prediction, as PNG files."""
    track, cols = load_track("data/fsg2019.csv", dtype=F64, device="cpu")
    T = 5
    s = torch.linspace(0.0, 20.0, T, dtype=F64)
    cx, cy = track.position(s)
    x = torch.zeros((2, T, 7), dtype=F64)
    x[1, :, 0], x[1, :, 1], x[1, :, 3] = cx, cy, 5.0

    @dataclasses.dataclass
    class Out:
        x_history: torch.Tensor
        active: torch.Tensor
        n_history: torch.Tensor

    out = Out(x, torch.ones((2, T), dtype=torch.bool),
              torch.zeros((2, T), dtype=F64))
    for path in (viz.plot_lap(track, out, cols, str(tmp_path / "lap.png"),
                              title="fsg2019", instance=1),
                 viz.plot_telemetry(out, path=str(tmp_path / "tel.png"),
                                    instance=1),
                 viz.plot_prediction(
                     track, x[1, 0], torch.stack(
                         [s, torch.zeros_like(s), torch.zeros_like(s)], -1),
                     str(tmp_path / "pred.png"))):
        with open(path, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"
