"""Closed-loop lap simulator, batch-first (port of
``fsae_mpc_tpu.sim.closed_loop``).

One lap per instance of a batch, one control tick per ``mpc.dt`` of
simulated time:

  tick:  project the plant pose onto the track  ->  speed-ramp reference
         ->  solve the LTV-MPC QP (warm-started from the last tick)
         ->  actuate through PID loops + RK6 substeps of the Cartesian
             Pacejka plant  ->  per-tick traces

The controller's curvilinear model differs from the plant on purpose, so
the lap metrics are an end-to-end check.  An instance whose lap is done
(``s >= L``) keeps its state from then on; the others run on.  Every
tensor lives on the track's device: on the card, :func:`simulate` is a
fixed sequence of device work with no host synchronisation (the f32
presets are non-adaptive), and :func:`simulate_timed` steps from the host
and times each tick.

Only ``mode="ltv"`` with the speed-ramp reference is ported; the NMPC
modes and the raceline reference raise ``ValueError``.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..config import MPCParams, STEER_PID, VEL_PID, VehicleParams
from ..models import cartesian as cart
from ..models import curvilinear as cm
from ..models import integrators, pid, transforms
from ..mpc import ltv
from ..ops import ipm, riccati


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Static simulation configuration: the JAX package's fields less the
    NMPC modes' own (``sqp_iters``, ``stepper``, ``transcription``),
    which are not ported."""

    model: str = "kinematic"        # "kinematic" | "dynamic"
    mode: str = "ltv"               # "ltv" ("ms-nmpc", "c-nmpc" raise)
    n_ticks: int = 1000
    n_substeps: int = 10
    reference: str = "speed_ramp"   # ("raceline" raises)
    mpc: MPCParams = MPCParams()
    ipm: ipm.IpmOptions = ipm.IpmOptions()
    slack_eps: float = 1e-6         # slack-activation threshold
    qp_backend: str = "dense"       # "dense" | "riccati"
    conv_thresholds: tuple | None = None
                                    # (pres, mu) bars of the converged /
                                    # abnormal-exit metric; None: the
                                    # backend's own (CONV_THRESHOLDS)


@dataclasses.dataclass(frozen=True)
class SimOutputs:
    """Per-tick traces (B, T, ...) and per-instance summaries (B,)."""

    x_history: torch.Tensor       # (B, T, 7) plant states after each tick
    u_history: torch.Tensor       # (B, T, 2) first optimal control
    n_history: torch.Tensor       # (B, T) lateral offsets
    obj_history: torch.Tensor     # (B, T) optimal objective values
    slack_n: torch.Tensor         # (B, T)
    slack_tyre: torch.Tensor      # (B, T)
    solver_iters: torch.Tensor    # (B, T)
    qp_pres: torch.Tensor         # (B, T) solver primal residual
    qp_mu: torch.Tensor           # (B, T) solver complementarity measure
    converged: torch.Tensor       # (B, T) bool
    active: torch.Tensor          # (B, T) bool: tick ran before lap end
    fcr: torch.Tensor             # (B, T) rear lateral tyre force (plant)
    lap_time: torch.Tensor
    lap_done: torch.Tensor
    track_violation: torch.Tensor
    max_track_violation: torch.Tensor
    tyre_violation: torch.Tensor
    max_tyre_violation: torch.Tensor
    mean_objective: torch.Tensor
    abnormal_exit_frac: torch.Tensor
    slack_n_frac: torch.Tensor
    slack_tyre_frac: torch.Tensor
    mean_iters: torch.Tensor
    max_iters: torch.Tensor


# Per-backend (pres, mu) bars of the abnormal-exit metric, the JAX
# package's: each sits just above its backend's f32 residual floor on warm
# ticks (the Riccati recursion's floor lies above the dense path's), so
# one global bar would misread one backend.  Whatever reports
# abnormal_exit_frac says which bar it used.
CONV_THRESHOLDS = {"dense": (1e-6, 1e-3), "riccati": (2e-3, 1e-3)}


def _conv_bars(cfg: SimConfig):
    if cfg.conv_thresholds is not None:
        return cfg.conv_thresholds
    return CONV_THRESHOLDS.get(cfg.qp_backend, (1e-6, 1e-3))


def _check_config(cfg: SimConfig) -> None:
    if cfg.mode != "ltv":
        raise ValueError(f"mode={cfg.mode!r} (NMPC) is not ported; use "
                         "mode='ltv'")
    if cfg.reference != "speed_ramp":
        raise ValueError(f"reference={cfg.reference!r} is not ported (it "
                         "needs the min-time planner); use 'speed_ramp'")
    if cfg.model not in ("kinematic", "dynamic"):
        raise ValueError(f"unknown model={cfg.model!r}")
    if cfg.qp_backend not in ("dense", "riccati"):
        raise ValueError(f"unknown qp_backend={cfg.qp_backend!r}")


def _initial_guess(cfg: SimConfig, Bsz, dtype, device):
    """The MPC's first linearisation trajectory: quadratic arclength and a
    linear speed ramp at 10 m/s^2, constant acceleration control."""
    N, dt = cfg.mpc.n_steps, cfg.mpc.dt
    nx = 5 if cfg.model == "kinematic" else 7
    t = dt * torch.arange(1, N + 1, dtype=dtype, device=device)
    x_opt = torch.zeros((Bsz, N, nx), dtype=dtype, device=device)
    x_opt[:, :, 0] = 10.0 * t ** 2 / 2.0
    x_opt[:, :, 3] = 10.0 * t
    u_opt = torch.zeros((Bsz, N, 2), dtype=dtype, device=device)
    u_opt[:, :, 0] = 10.0
    return x_opt, u_opt


def _reference(cfg: SimConfig, x0, plant_vx):
    """Speed ramp toward the target velocity, (B, N, nx)."""
    N, dt, tv = cfg.mpc.n_steps, cfg.mpc.dt, cfg.mpc.target_vel
    steps = torch.arange(1, N + 1, dtype=x0.dtype, device=x0.device)
    up = torch.clamp_max(x0[:, 3:4] + 10.0 * dt * steps, tv)
    down = torch.clamp_min(x0[:, 3:4] - 10.0 * dt * steps, tv)
    v_ref = torch.where((plant_vx < tv)[:, None], up, down)
    x_ref = torch.zeros(x0.shape[:1] + (N,) + x0.shape[1:], dtype=x0.dtype,
                        device=x0.device)
    x_ref[:, :, 3] = v_ref
    x_ref[:, :, 0] = x0[:, 0:1] + torch.cumsum(v_ref * dt, 1)
    return x_ref


def _zero_warm(cfg: SimConfig, Bsz, dtype, device):
    """The first tick's warm start: the solver's result of the backend
    with every entry 0 (the IPM floors it), as the JAX package seeds it.
    Its shapes are written out here, not taken from a solve: rows per
    stage r and slacks ns of the model's QP (``mpc/ltv.py``'s groups; a
    soft two-sided group emits a lower and an upper row)."""
    mpc = cfg.mpc
    N, nu = mpc.n_steps, 2
    if cfg.model == "kinematic":
        # box [v, delta] (hard), track n, lateral-acceleration proxy
        nx, r, ns = 5, 2 + 2 + 2, 1
    else:
        # box [x_d, delta] (hard), track n, rear and front slip, friction
        # polygon (upper side only)
        nx, r, ns = 7, 2 + 2 + 4 + mpc.n_tyre_polygon, 4
    z = lambda *shape: torch.zeros((Bsz,) + shape, dtype=dtype,
                                   device=device)
    its = torch.zeros((Bsz,), dtype=torch.int32, device=device)
    if cfg.qp_backend == "riccati":
        return riccati.StageIpmResult(
            u=z(N, nu), x=z(N, nx), s=z(ns), lam=z(N, nx), z_u=z(N, nu),
            z_s=z(ns), z_rows=z(N, r), iterations=its, mu=z(),
            primal_res=z(), dual_res=z(), objective=z())
    n = N * nu + ns
    return ipm.IpmResult(x=z(n), z_bounds=z(n), z_rows=z(N * r),
                         iterations=its, mu=z(), primal_res=z(),
                         dual_res=z(), objective=z())


def plant_substeps(x, v_ref, delta_ref, pids, params: VehicleParams, dt,
                   n_substeps: int):
    """Actuate the plant for one tick of ``dt``: ``n_substeps`` of the
    velocity and steering PID loops (toward ``v_ref``, ``delta_ref``) and
    an RK6 step of the Cartesian dynamic plant.  ``x`` (B, 7); ``pids``
    the two loops' states.  Returns the new state and PID states."""
    vel_pid, steer_pid = pids
    f = lambda xx, uu: cart.f_cart_dyn(xx, uu, params)
    for _ in range(n_substeps):
        fx, vel_pid = pid.pid_step(v_ref, x[:, 3], VEL_PID, vel_pid)
        sr, steer_pid = pid.pid_step(delta_ref, x[:, 6], STEER_PID,
                                     steer_pid)
        x = integrators.rk6_step(f, x, torch.stack([fx, sr], -1),
                                 dt / n_substeps)
    return x, (vel_pid, steer_pid)


def _freeze(done, old, new):
    """``old`` where the instance's lap is done, else ``new``, leaf by
    leaf over tensors, tuples and result dataclasses."""
    if isinstance(new, tuple):
        return tuple(_freeze(done, a, b) for a, b in zip(old, new))
    if dataclasses.is_dataclass(new):
        return dataclasses.replace(new, **{
            f.name: _freeze(done, getattr(old, f.name), getattr(new, f.name))
            for f in dataclasses.fields(new)})
    mask = done.reshape(done.shape + (1,) * (new.ndim - 1))
    return torch.where(mask, old, new)


def _build_tick(track, params: VehicleParams, cfg: SimConfig, x_init):
    """The per-tick transition ``tick(carry) -> (carry, out)`` and its
    initial carry ``(x, x_opt, u_opt, pids, done, warm)``.  Shared by
    :func:`simulate` and :func:`simulate_timed`."""
    _check_config(cfg)
    dtype, device = track.px.dtype, track.px.device
    kinematic = cfg.model == "kinematic"
    nx = 5 if kinematic else 7
    mpc, dt = cfg.mpc, cfg.mpc.dt
    if x_init is None:
        x_init = torch.zeros((1, 7), dtype=dtype, device=device)
    x_init = x_init.reshape(-1, 7).to(device=device, dtype=dtype)
    Bsz = x_init.shape[0]
    base = ltv.ltv_mpc_kinematic if kinematic else ltv.ltv_mpc_dynamic
    c_pres, c_mu = _conv_bars(cfg)

    def tick(carry):
        x, x_opt, u_opt, pids, done, warm = carry

        # project onto the track, warm-started at the first predicted s
        s, n, mu = transforms.cartesian_to_curvilinear(
            x[:, 0], x[:, 1], x[:, 2], track, x_opt[:, 0, 0])
        if kinematic:
            x0 = torch.stack([s, n, mu, torch.hypot(x[:, 3], x[:, 4]),
                              x[:, 6]], -1)
        else:
            x0 = torch.stack([s, n, mu, x[:, 3], x[:, 4], x[:, 5], x[:, 6]],
                             -1)
        done = done | (s >= track.L)

        res = base(x0, _reference(cfg, x0, x[:, 3]), track, params, mpc,
                   x_opt, u_opt, cfg.ipm, warm=warm,
                   backend=cfg.qp_backend)

        # actuation setpoints: the first predicted stage
        x_new, pids_new = plant_substeps(x, res.x_opt[:, 0, 3],
                                         res.x_opt[:, 0, nx - 1], pids,
                                         params, dt, cfg.n_substeps)

        # an instance whose lap is done keeps everything from then on
        x = _freeze(done, x, x_new)
        x_opt = _freeze(done, x_opt, res.x_opt)
        u_opt = _freeze(done, u_opt, res.u_opt)
        pids = _freeze(done, pids, pids_new)
        warm = _freeze(done, warm, res.qp)

        # the per-instance model reads its state along the first axis
        fcr = cm.rear_lateral_force(x.T, params)
        converged = (res.qp.primal_res < c_pres) & (res.qp.mu < c_mu)
        out = dict(
            x=x, u=res.u_opt[:, 0], n=n, obj=res.fval,
            slack_n=res.slack[:, 0], slack_tyre=res.slack[:, -1],
            iters=res.qp.iterations, converged=converged,
            pres=res.qp.primal_res, mu=res.qp.mu,
            active=torch.logical_not(done), fcr=fcr)
        return (x, x_opt, u_opt, pids, done, warm), out

    x_opt0, u_opt0 = _initial_guess(cfg, Bsz, dtype, device)
    zero = torch.zeros((Bsz,), dtype=dtype, device=device)
    pids0 = (pid.pid_init(zero), pid.pid_init(zero))
    carry0 = (x_init, x_opt0, u_opt0, pids0,
              torch.zeros((Bsz,), dtype=torch.bool, device=device),
              _zero_warm(cfg, Bsz, dtype, device))
    return tick, carry0


def _stack(outs):
    return {k: torch.stack([o[k] for o in outs], 1) for k in outs[0]}


def simulate(track, params: VehicleParams = VehicleParams(),
             cfg: SimConfig = SimConfig(), x_init=None) -> SimOutputs:
    """Run ``cfg.n_ticks`` closed-loop ticks of a batch of laps.

    ``x_init``: (B, 7) initial Cartesian plant states on the track's
    device (default: one instance at rest at the origin).  Every lap runs
    all ``n_ticks``; an instance whose lap is done is frozen, so nothing
    here waits for the device.
    """
    tick, carry = _build_tick(track, params, cfg, x_init)
    outs = []
    for _ in range(cfg.n_ticks):
        carry, out = tick(carry)
        outs.append(out)
    return _summarise(_stack(outs), cfg, params)


def simulate_timed(track, params: VehicleParams = VehicleParams(),
                   cfg: SimConfig = SimConfig(), x_init=None):
    """:func:`simulate` stepped from the host, timing every tick on the
    host's clock: one synchronisation per tick (reading whether every lap
    is done), and an early stop once every lap is.

    A first tick, discarded, loads the kernel libraries.  Returns
    ``(SimOutputs, timing)``: the outputs over the ticks run, and the
    mean, median, p99 and max tick seconds beside ``budget_s = mpc.dt``.
    """
    tick, carry0 = _build_tick(track, params, cfg, x_init)
    bool(tick(carry0)[0][4].all())         # first use; not advanced
    carry = carry0
    outs, times = [], []
    for _ in range(cfg.n_ticks):
        t0 = time.perf_counter()
        carry, out = tick(carry)
        finished = bool(carry[4].all())    # waits for the tick
        times.append(time.perf_counter() - t0)
        outs.append(out)
        if finished:
            break
    t = np.asarray(times)
    timing = {
        "n_ticks_timed": int(t.size),
        "tick_time_mean_s": float(t.mean()),
        "tick_time_median_s": float(np.median(t)),
        "tick_time_p99_s": float(np.quantile(t, 0.99)),
        "tick_time_max_s": float(t.max()),
        "budget_s": float(cfg.mpc.dt),
    }
    return _summarise(_stack(outs), cfg, params), timing


def _summarise(tr, cfg: SimConfig, params: VehicleParams) -> SimOutputs:
    """Per-instance metrics over the traces' tick axis."""
    dt = cfg.mpc.dt
    active = tr["active"]
    act = active.to(tr["n"].dtype)
    n_act = torch.clamp_min(act.sum(1), 1.0)

    tv = torch.clamp_min(tr["n"].abs() - cfg.mpc.n_max, 0.0) * act
    fe = ((tr["fcr"] / (params.m * params.ac_max)) ** 2
          + (tr["u"][..., 0] / params.al_max) ** 2)
    fe_exc = torch.clamp_min(fe - 1.0, 0.0) * act

    slack_free = ((tr["slack_n"] < cfg.slack_eps)
                  & (tr["slack_tyre"] < cfg.slack_eps) & active)
    sf = slack_free.to(act.dtype)
    frac = lambda flag: (flag.to(act.dtype) * act).sum(1) / n_act

    return SimOutputs(
        x_history=tr["x"], u_history=tr["u"], n_history=tr["n"],
        obj_history=tr["obj"], slack_n=tr["slack_n"],
        slack_tyre=tr["slack_tyre"], solver_iters=tr["iters"],
        qp_pres=tr["pres"], qp_mu=tr["mu"],
        converged=tr["converged"], active=active, fcr=tr["fcr"],
        lap_time=act.sum(1) * dt,
        lap_done=torch.logical_not(active[:, -1]),
        track_violation=tv.sum(1) * dt,
        max_track_violation=tv.amax(1),
        tyre_violation=fe_exc.sum(1) * dt,
        max_tyre_violation=fe_exc.amax(1),
        mean_objective=((tr["obj"] * sf).sum(1)
                        / torch.clamp_min(sf.sum(1), 1.0)),
        abnormal_exit_frac=frac(torch.logical_not(tr["converged"])),
        slack_n_frac=frac(tr["slack_n"] >= cfg.slack_eps),
        slack_tyre_frac=frac(tr["slack_tyre"] >= cfg.slack_eps),
        mean_iters=(tr["iters"] * act).sum(1) / n_act,
        max_iters=torch.where(active, tr["iters"], 0).amax(1),
    )
