"""What must stay apart in the PyTorch port, and what crosses over.

  * instances of a batch: a NaN-poisoned Riccati pivot or dense Cholesky
    pivot stays in its instance, and a batched tick equals one-instance
    ticks on both backends (every reduction and selection of the solvers
    is per instance);
  * the card and the plain versions: a kernel wrapper refuses what its
    CUDA kernel cannot run instead of falling back, and a solver refuses
    options it has no counterpart for;
  * the two packages: the port imports no JAX; ``interop`` carries the
    JAX package's parameters, presets, ``StageQP`` and ``IpmResult``
    across unchanged; the port's entry points put their tensors on the
    CUDA device unless the caller asks for the CPU.

All on the CPU in f64; nothing here compiles a JAX function.  The file
keeps six tests: xdist's ``--dist loadfile`` queues files by test count,
and a seventh would move it ahead of the suite's longest file.
"""

import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fsae_mpc_tpu import config as jconfig
from fsae_mpc_tpu.ops import ipm as jipm
from fsae_mpc_tpu.ops import riccati as jriccati

from fsae_mpc_tpu_torch import interop
from fsae_mpc_tpu_torch.config import MPC_F32, VehicleParams
from fsae_mpc_tpu_torch.mpc import ltv
from fsae_mpc_tpu_torch.ops import ipm, riccati
from fsae_mpc_tpu_torch.ops.kernels import chol as kchol
from fsae_mpc_tpu_torch.ops.kernels import condense as kcondense
from fsae_mpc_tpu_torch.ops.kernels import riccati as kr
from fsae_mpc_tpu_torch.track import load_track


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are tiny: one intra-op thread keeps this file's
    PyTorch work off the cores that the suite's other files share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


F64 = torch.float64
B, N, NX, NU = 3, 5, 7, 2


def _factor_inputs(seed=5):
    rng = np.random.default_rng(seed)
    Ad = 0.8 * (np.eye(NX) + 0.1 * rng.standard_normal((B, N, NX, NX)))
    L = 0.3 * rng.standard_normal((B, N, NX, NX))
    Qb = np.einsum("bnij,bnkj->bnik", L, L) + np.eye(NX)
    Rb = np.broadcast_to(np.eye(NU), (B, N, NU, NU)).copy()
    return [torch.as_tensor(a, dtype=F64) for a in (
        Ad, rng.standard_normal((B, N, NX, NU)), Qb, Rb,
        0.1 * rng.standard_normal((B, N, NX, NU)))]


def test_nan_poison_stays_in_its_instance():
    """An indefinite 2x2 pivot NaN-poisons its instance (from that stage
    back to stage 0) and leaves the other instances untouched."""
    Ad, Bd, Qb, Rb, M = _factor_inputs()
    Rb_bad = Rb.clone()
    Rb_bad[1, 3] = torch.tensor([[-50.0, 0.0], [0.0, 1.0]], dtype=F64)
    clean = kr.factor_ref(Ad, Bd, Qb, Rb, M)
    huinv, G, W = kr.factor_ref(Ad, Bd, Qb, Rb_bad, M)
    # stage 3's pivot is NaN; P_3 and so every earlier stage follow
    assert torch.isnan(huinv[1, :4]).all()
    assert torch.isnan(G[1, :3]).all() and torch.isnan(W[1, :3]).all()
    for o, c in zip((huinv, G, W), clean):
        torch.testing.assert_close(o[[0, 2]], c[[0, 2]], rtol=0, atol=0)
        torch.testing.assert_close(o[1, 4:], c[1, 4:], rtol=0, atol=0)
    # the dense Cholesky factor: an indefinite KKT matrix poisons its own
    # instance only, and the solve carries the NaN to that instance's step
    K = torch.einsum("bij,bkj->bik", Qb[:, 0], Qb[:, 0]) + torch.eye(NX)
    K_bad = K.clone()
    K_bad[1] -= 1e3 * torch.eye(NX, dtype=F64)
    L, L_bad = kchol.factor(K), kchol.factor(K_bad)
    rhs = torch.ones((B, NX), dtype=F64)
    x_bad = kchol.solve(L_bad, rhs)
    assert torch.isnan(L_bad[1]).all() and torch.isnan(x_bad[1]).all()
    torch.testing.assert_close(L_bad[[0, 2]], L[[0, 2]], rtol=0, atol=0)
    torch.testing.assert_close(x_bad[[0, 2]], kchol.solve(L, rhs)[[0, 2]],
                               rtol=0, atol=0)


@pytest.mark.parametrize("preset", ["F32_OPTS", "F32_PRODUCTION"])
def test_batched_solve_equals_single_solves(preset):
    """Per-instance reductions must not leak across the batch: a batched
    tick equals B one-instance ticks (to summation-order roundoff), on
    the Riccati and on the dense backend."""
    n = 8
    mpc = dataclasses.replace(MPC_F32, n_steps=n)
    track, _ = load_track("data/fsg2019.csv", dtype=F64,
                          device="cpu")
    params = VehicleParams()
    t = mpc.dt * torch.arange(1, n + 1, dtype=F64)
    x0 = torch.zeros((B, 7), dtype=F64)
    x0[:, 0] = torch.tensor([3.0, 41.0, 97.0])
    x0[:, 1] = torch.tensor([0.1, -0.15, 0.05])
    x0[:, 3] = torch.tensor([8.0, 7.0, 9.0])
    x_lin = torch.zeros((B, n, 7), dtype=F64)
    x_lin[:, :, 0] = 8.0 * t
    x_lin[:, :, 3] = 8.0
    v = torch.clamp_max(x0[:, 3:4] + 10.0 * t, 20.0)
    x_ref = torch.zeros((B, n, 7), dtype=F64)
    x_ref[:, :, 3] = v
    x_ref[:, :, 0] = x0[:, 0:1] + torch.cumsum(v * mpc.dt, 1)
    u_lin = torch.zeros((B, n, 2), dtype=F64)
    opts = getattr(ipm, preset)
    args = (x0, x_ref, x_lin, u_lin)
    for backend in ("riccati", "dense"):
        batched = ltv.ltv_mpc_dynamic(x0, x_ref, track, params, mpc, x_lin,
                                      u_lin, opts, backend=backend)
        for b in range(B):
            a = [v[b:b + 1] for v in args]
            one = ltv.ltv_mpc_dynamic(a[0], a[1], track, params, mpc, a[2],
                                      a[3], opts, backend=backend)
            np.testing.assert_allclose(one.u_opt.numpy()[0],
                                       batched.u_opt.numpy()[b], rtol=0,
                                       atol=1e-9, err_msg=backend)
            np.testing.assert_allclose(one.slack.numpy()[0],
                                       batched.slack.numpy()[b], rtol=0,
                                       atol=1e-9, err_msg=backend)


def test_kernel_wrappers_refuse_what_they_cannot_run(monkeypatch):
    fac = _factor_inputs()
    with pytest.raises(ValueError, match="no Riccati kernel"):
        kr.factor(*[t.to("meta") for t in fac])
    with pytest.raises(ValueError, match="CUDA tensor"):
        kr.factor_cuda(*fac)
    with pytest.raises(ValueError, match="nu == 2"):
        kr.apply_cuda(*[torch.zeros(B, N, 3, 3)] * 4,
                      torch.zeros(B, N, 3, 3), torch.zeros(B, N, 3, 3),
                      *[torch.zeros(B, 1, N, 3)] * 3)
    Ad, Bd = fac[0], fac[1]
    dd = torch.zeros((B, N, NX), dtype=F64)
    with pytest.raises(ValueError, match="no condense kernel"):
        kcondense.condense(Ad.to("meta"), Bd.to("meta"), dd.to("meta"))
    with pytest.raises(ValueError, match="CUDA tensor"):
        kcondense.condense_cuda(Ad, Bd, dd)
    K = torch.eye(NX, dtype=F64).repeat(B, 1, 1)
    with pytest.raises(ValueError, match="no Cholesky kernel"):
        kchol.factor(K.to("meta"))
    with pytest.raises(ValueError, match="CUDA tensor"):
        kchol.factor_cuda(K)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kchol.solve_cuda(K, K[:, 0])
    # the solvers: the blocked Cholesky route (plain PyTorch on any device,
    # no hand kernel) solves what the plain Cholesky solves, an unknown
    # route raises, and the stage-wise solver rejects the condensed-only
    # options (as the JAX package's _check_stage_opts does) instead of
    # ignoring them
    qp = [K, K[:, 0], K, -K[:, 0], K[:, 0], -K[:, 0], K[:, 0]]
    blocked = ipm.solve_qp(*qp, ipm.IpmOptions(chol="blocked"))
    lapack = ipm.solve_qp(*qp, ipm.IpmOptions(chol="lapack"))
    torch.testing.assert_close(blocked.x, lapack.x, rtol=0, atol=1e-9)
    with pytest.raises(ValueError, match="unknown chol"):
        ipm.solve_qp(*qp, ipm.IpmOptions(chol="pallas"))
    for field, value in (("polish", 1), ("scale_kkt", True),
                         ("comp_resid", True), ("correctors", 1),
                         ("var_scale", True)):
        with pytest.raises(ValueError, match="condensed-only"):
            riccati.solve_stage_qp(
                None, dataclasses.replace(ipm.IpmOptions(),
                                          **{field: value}))
    # on the card, the solvers' entry check refuses what the kernels cannot
    # run, naming the route that runs it; it reads the device type alone,
    # so it is checked here without a card
    cuda, cpu, f32 = torch.device("cuda"), torch.device("cpu"), torch.float32
    kr.check_entry(cuda, f32, 7, 2, 4)              # the main path
    kr.check_entry(cuda, f32, 5, 2, 1)              # the kinematic widths
    kr.check_entry(cuda, f32, 9, 2, 2)              # trapezoidal dynamic
    for dtype, nx, nu, ns in ((F64, 7, 2, 4), (f32, 7, 3, 4),
                              (f32, 6, 2, 4), (f32, 7, 2, 3)):
        with pytest.raises(ValueError, match='device="cpu"'):
            kr.check_entry(cuda, dtype, nx, nu, ns)
        kr.check_entry(cpu, dtype, nx, nu, ns)      # the plain versions
    for n in (84, 81):
        kchol.check_entry(cuda, f32, n, "auto")
    for dtype, n in ((F64, 84), (f32, kchol.MAX_N + 1)):
        with pytest.raises(ValueError, match='chol="lapack"'):
            kchol.check_entry(cuda, dtype, n, "auto")
        kchol.check_entry(cuda, dtype, n, "lapack")
        kchol.check_entry(cuda, dtype, n, "blocked")
        kchol.check_entry(cpu, dtype, n, "auto")
    # ... and both solvers ask it first, with the problem's widths
    seen = []

    def spy(*args):
        seen.append(args)
        raise LookupError

    monkeypatch.setattr(kr, "check_entry", spy)
    monkeypatch.setattr(kchol, "check_entry", spy)
    sqp = {f.name: None for f in dataclasses.fields(riccati.StageQP)}
    sqp.update(Ad=fac[0], Bd=fac[1], g_s=torch.zeros((B, 4), dtype=F64))
    with pytest.raises(LookupError):
        riccati.solve_stage_qp(riccati.StageQP(**sqp), ipm.F32_OPTS)
    with pytest.raises(LookupError):
        ipm.solve_qp(*qp, ipm.F32_OPTS)
    assert seen == [(cpu, F64, NX, NU, 4), (cpu, F64, NX, "auto")]


def test_port_never_imports_jax():
    """The slice's modules import neither ``jax`` nor the JAX package (the
    GPU machine has no JAX), and ``utils.viz`` imports matplotlib only
    when it plots (the GPU machine has no matplotlib)."""
    code = ("import sys, fsae_mpc_tpu_torch.mpc.ltv, "
            "fsae_mpc_tpu_torch.sim.batch, fsae_mpc_tpu_torch.sim.checkpoint, "
            "fsae_mpc_tpu_torch.parallel, fsae_mpc_tpu_torch.parallel.mesh, "
            "fsae_mpc_tpu_torch.utils.profiling, "
            "fsae_mpc_tpu_torch.utils.debug, fsae_mpc_tpu_torch.utils.viz, "
            "fsae_mpc_tpu_torch.utils.tree, "
            "fsae_mpc_tpu_torch.models.instances, "
            "fsae_mpc_tpu_torch.interop, fsae_mpc_tpu_torch.track, "
            "fsae_mpc_tpu_torch.sim, fsae_mpc_tpu_torch.models.cartesian, "
            "fsae_mpc_tpu_torch.models.transforms, "
            "fsae_mpc_tpu_torch.models.pid, fsae_mpc_tpu_torch.mpc.sqp, "
            "fsae_mpc_tpu_torch.mpc.collocation, "
            "fsae_mpc_tpu_torch.ops.linalg, fsae_mpc_tpu_torch.ops.condense, "
            "fsae_mpc_tpu_torch.ops.structured, fsae_mpc_tpu_torch.runtime, "
            "fsae_mpc_tpu_torch.runtime.native_lib, "
            "fsae_mpc_tpu_torch.utils.io, "
            "fsae_mpc_tpu_torch.planner, "
            "fsae_mpc_tpu_torch.planner.min_time, "
            "fsae_mpc_tpu_torch.planner.reference; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'fsae_mpc_tpu.', 'matplotlib'))]; "
            "assert not bad, bad")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], cwd=root, check=True,
                   timeout=120)


def test_interop_carries_params_and_stage_qp():
    """The JAX package's parameters, IPM presets, a (batched) StageQP and
    an IpmResult, as numpy, come across unchanged: every field, in the
    port's batch-first layout.  Without ``device`` they go to the CUDA
    device, so a call that does not ask for the CPU fails where there is
    no card."""
    vp = interop.vehicle_params(dataclasses.asdict(jconfig.VehicleParams()))
    assert vp == VehicleParams()
    mp = interop.mpc_params(dataclasses.asdict(jconfig.MPC_F32))
    assert mp == MPC_F32
    for name in ("F32_OPTS", "F32_ACCURATE", "F32_BALANCED",
                 "F32_PRODUCTION"):
        assert (dataclasses.asdict(getattr(ipm, name))
                == dataclasses.asdict(getattr(jipm, name))), name
    assert (dataclasses.asdict(ipm.IpmOptions())
            == dataclasses.asdict(jipm.IpmOptions()))
    res = {f.name: np.arange(B * 3.0).reshape(B, 3)
           for f in dataclasses.fields(jipm.IpmResult)}
    res["iterations"] = np.array([12, 7, 30], np.int32)
    back = interop.to_numpy(interop.ipm_result(res, device="cpu"))
    for name, v in res.items():
        np.testing.assert_array_equal(back[name], v)
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            load_track("data/fsg2019.csv")
        with pytest.raises((AssertionError, RuntimeError)):
            interop.ipm_result(res)
    rng = np.random.default_rng(0)
    r, ns = 20, 4
    shapes = dict(Ad=(N, NX, NX), Bd=(N, NX, NU), dd=(N, NX), x0=(NX,),
                  Qx=(N, NX), qx=(N, NX), Ru=(N, NU), ru=(N, NU), g_s=(ns,),
                  C=(N, r, NX), D=(N, r, NU), Ws=(N, r, ns), lbA=(N, r),
                  ubA=(N, r), u_lb=(N, NU), u_ub=(N, NU), s_lb=(ns,),
                  s_ub=(ns,))
    jqp = jriccati.StageQP(**{
        f.name: jnp.asarray(rng.standard_normal((B,) + shapes[f.name]))
        for f in dataclasses.fields(jriccati.StageQP)})
    src = {f.name: np.asarray(getattr(jqp, f.name))
           for f in dataclasses.fields(jqp)}
    qp = interop.stage_qp(src, device="cpu")
    back = interop.to_numpy(qp)
    assert back.keys() == src.keys()
    for name, v in src.items():
        np.testing.assert_array_equal(back[name], v)
    assert qp.Ad.dtype == F64 and qp.Ad.shape == (B, N, NX, NX)
    # without a dtype, the data takes the device's: float32 on the card
    # (the kernels take nothing else), float64 on the CPU
    for dev in ("cuda", "cuda:0", torch.device("cuda", 0)):
        assert interop.default_dtype(dev) == torch.float32
    for dev in ("cpu", torch.device("cpu")):
        assert interop.default_dtype(dev) == F64
    assert interop.stage_qp(src, torch.float32, device="cpu").Ad.dtype == \
        torch.float32
