#!/usr/bin/env python3
"""Reference numbers for the closed-loop phases of ``chip_smoke.py``,
computed on a CPU.

    python3 tools/sim_reference.py t64
    python3 tools/sim_reference.py port-lap
    python3 tools/sim_reference.py plan64 [--nodes 160] [--port]
                                          [--threads T] [--out PLAN.npz]
    python3 tools/sim_reference.py divergence [--ticks 20] [--check 4]
                                              [--nmpc | --raceline PLAN.npz
                                               | --pod POD.json]
                                              [--only KEY ...]
    python3 tools/sim_reference.py routes [--check 8]

``t64``: the JAX package's f64 lap of fsg2019 in the configuration of its
``tests/test_laps.py`` f32-equivalence test (dynamic model, dense backend,
``MPC_F32`` weights, ``IpmOptions(max_iters=30, adaptive=False)``, 700
ticks): lap time, ``lap_done`` and the violations.  It imports ``jax`` and
``fsae_mpc_tpu`` and so runs where they are installed, never on the card's
machine; ``chip_smoke.py`` pins the number it prints (``LAP_T64``).

``port-lap``: the same lap by the port on the CPU in f64
(``simulate_timed``, stopping when the lap is done).

``plan64``: the JAX package's f64 dynamic minimum-time plan of fsg2019 at
``--nodes`` nodes (default 160, ``chip_smoke.PLAN_REF_NODES``) and its
other defaults (40 SQP iterations, ``IpmOptions()``): lap time, defect and
slacks; it needs JAX, like ``t64``, and ``chip_smoke.py`` pins its lap
time (``PLAN_T64``).  At the planner's default 500 nodes one SQP
iteration takes ~4 minutes on a few CPU cores (a QP of 4,002 variables
and 5,500 rows), so the CPU's reference is taken at 160, the fewest nodes
at which the plan converges.  ``--port``: the
port's f64 plan on the CPU, the same call, with ``--threads`` intra-op
threads (the gaps between these plans set ``PLAN_TIME_TOL``).  ``--out``:
the plan's fields as a numpy archive.

``divergence``: the port's ``simulate`` on the CPU for ``chip_smoke.py``'s
phase-4 scenarios (instances 0..check-1 of ``sim_scenarios``) and
configurations, in f32 and in f64, and the largest |x_f32 - x_f64| over
the ticks per plant state: the floor below which the card's f32 laps
cannot be held to the CPU's.  With ``--nmpc``: the same for phase 6's
NMPC configurations (``chip_smoke.NMPC_CONFIGS``), keyed as
``chip_smoke.Loop.key``; with ``--raceline PLAN.npz``: phase 7's raceline
loop (``chip_smoke.RACELINE_CONFIG``) tracking that plan (a ``plan64
--out`` archive, or the card's plan that ``chip_smoke.py`` writes where
``PLAN_OUT`` names a file).  ``--only``: just the configurations whose
``Loop.key`` is given (e.g. ``c-nmpc/kinematic/hs``).  With ``--pod
POD.json``: phase 8's checked instances (``chip_smoke.POD_CHECK``, two per
track, each on its own track) with the vehicles the card drew for them
(the file ``chip_smoke.py`` writes where ``POD_OUT`` names one), from
rest, in ``chip_smoke.POD_CONFIG``; keyed ``"pod"``.

``routes``: the bases of phase 9's tolerances on the CPU, at phase 3's
first ``--check`` instances: the structured rows' plain f32 products
against ``materialize()``'s and their compensated ones against f64
(``chip_smoke.genrows_errors``: ``GENROWS_TOL``), and the native
active-set QP against the f64 dense IPM on the first 4 dense QPs in f64
(``chip_smoke.activeset_rows``: ``ACTIVESET_X_TOL``), with the IPM at 60
and 200 iterations and on H plus the active-set's own regularisation
(1e-11 max |H| on the diagonal).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
TRACK = os.path.join(ROOT, "data", "fsg2019.csv")


def t64():
    import jax
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    from fsae_mpc_tpu.config import MPC_F32, VehicleParams
    from fsae_mpc_tpu.ops import ipm
    from fsae_mpc_tpu.sim.closed_loop import SimConfig, simulate
    from fsae_mpc_tpu.track import load_track

    track, _ = load_track(TRACK, dtype=jnp.float64)
    cfg = SimConfig(model="dynamic", mode="ltv", n_ticks=700, mpc=MPC_F32,
                    ipm=ipm.IpmOptions(max_iters=30, adaptive=False))
    t0 = time.perf_counter()
    out = jax.block_until_ready(jax.jit(lambda t, p: simulate(t, p, cfg))(
        track, VehicleParams()))
    return _summary(out, time.perf_counter() - t0)


def port_lap():
    import torch
    from fsae_mpc_tpu_torch.config import MPC_F32, VehicleParams
    from fsae_mpc_tpu_torch.ops import ipm
    from fsae_mpc_tpu_torch.sim import SimConfig, simulate_timed
    from fsae_mpc_tpu_torch.track import load_track

    track, _ = load_track(TRACK, dtype=torch.float64, device="cpu")
    cfg = SimConfig(model="dynamic", mode="ltv", n_ticks=700, mpc=MPC_F32,
                    ipm=ipm.IpmOptions(max_iters=30, adaptive=False))
    t0 = time.perf_counter()
    out, timing = simulate_timed(track, VehicleParams(), cfg)
    d = _summary(out, time.perf_counter() - t0, index=0)
    d["ticks"] = timing["n_ticks_timed"]
    return d


def plan64(nodes, iters, port=False, threads=None, out=None):
    import numpy as np
    if port:
        import torch
        if threads:
            torch.set_num_threads(threads)
        from fsae_mpc_tpu_torch import interop
        from fsae_mpc_tpu_torch.config import VehicleParams
        from fsae_mpc_tpu_torch.planner import minimum_time_planner_dynamic
        from fsae_mpc_tpu_torch.track import load_track

        track, _ = load_track(TRACK, dtype=torch.float64, device="cpu")
        t0 = time.perf_counter()
        plan = interop.to_numpy(minimum_time_planner_dynamic(
            track, VehicleParams(), n_nodes=nodes, iters=iters))
    else:
        import jax
        jax.config.update("jax_enable_x64", True)
        import jax.numpy as jnp
        from fsae_mpc_tpu.config import VehicleParams
        from fsae_mpc_tpu.planner import minimum_time_planner_dynamic
        from fsae_mpc_tpu.track import load_track

        track, _ = load_track(TRACK, dtype=jnp.float64)
        t0 = time.perf_counter()
        res = jax.block_until_ready(jax.jit(
            lambda t: minimum_time_planner_dynamic(
                t, VehicleParams(), n_nodes=nodes, iters=iters))(track))
        plan = {k: np.asarray(v) for k, v in vars(res).items()}
    seconds = time.perf_counter() - t0
    if out:
        np.savez(out, **plan)
    return {"lap_time": float(plan["lap_time"]),
            "defect_norm": float(plan["defect_norm"]),
            "slack": plan["slack"].tolist(), "merit": float(plan["merit"]),
            "mean_x_d": float(plan["y_opt"][:, 2].mean()),
            "seconds": seconds}


def _summary(out, seconds, index=None):
    import numpy as np
    keys = ("lap_time", "lap_done", "track_violation", "max_track_violation",
            "tyre_violation", "abnormal_exit_frac", "mean_iters")
    pick = lambda v: np.asarray(v) if index is None else np.asarray(v)[index]
    d = {k: float(pick(getattr(out, k))) for k in keys}
    d["seconds"] = seconds
    return d


def divergence(ticks, check, nmpc=False, raceline=None, only=None,
               pod=None):
    import numpy as np
    import torch
    import chip_smoke
    from fsae_mpc_tpu_torch import interop
    from fsae_mpc_tpu_torch.config import MPC_F32, VehicleParams
    from fsae_mpc_tpu_torch.sim import simulate
    from fsae_mpc_tpu_torch.track import load_track

    # one intra-op thread, as chip_smoke.py's CPU laps run
    torch.set_num_threads(1)
    if pod:
        with open(pod) as f:
            fields = {k: np.asarray(v) for k, v in json.load(f).items()}
        return {"pod": _divergence(lambda dtype: simulate(
            *chip_smoke.pod_instances(fields, dtype),
            chip_smoke.POD_CONFIG.sim_config(ticks, MPC_F32),
            torch.zeros((len(chip_smoke.POD_CHECK), 7), dtype=dtype)),
            "pod")}
    x_init = chip_smoke.sim_scenarios(check)
    configs = (chip_smoke.NMPC_CONFIGS if nmpc else
               [chip_smoke.RACELINE_CONFIG] if raceline else
               chip_smoke.SIM_CONFIGS)
    if only:
        configs = [c for c in configs if c.key in only]
    plan = None
    if raceline:
        with np.load(raceline) as f:
            plan = interop.planner_result(dict(f), device="cpu")
    out = {}
    for loop in configs:
        cfg = loop.sim_config(ticks, MPC_F32)
        out[loop.key] = _divergence(lambda dtype: simulate(
            load_track(TRACK, dtype=dtype, device="cpu")[0],
            VehicleParams(), cfg, torch.tensor(x_init, dtype=dtype),
            plan=plan), loop.tag)
    return out


def routes(check):
    import torch
    import chip_smoke
    from fsae_mpc_tpu_torch.config import MPC_F32, VehicleParams
    from fsae_mpc_tpu_torch.mpc import ltv
    from fsae_mpc_tpu_torch.ops import ipm
    from fsae_mpc_tpu_torch.track import load_track

    torch.set_num_threads(1)
    track, _ = load_track(TRACK, dtype=torch.float32, device="cpu")
    xc, xl, ul = chip_smoke.initial_batch(check, MPC_F32, torch.float32,
                                          "cpu")
    args = (xc, chip_smoke.reference(xc, MPC_F32), track, VehicleParams(),
            MPC_F32, xl, ul)
    A = ltv.build_qp_dynamic(*args, structured="gen")[0][2]
    plain, comp = chip_smoke.genrows_errors(A)
    qp64 = [q[:4].double() for q in ltv.build_qp_dynamic(*args)[0][:7]]
    H = qp64[0]
    eye = torch.eye(H.shape[-1], dtype=H.dtype)
    reg = 1e-11 * H.abs().amax((1, 2)).clamp_min(1.0)[:, None, None] * eye
    keys = ("status", "dx", "du0", "dobj", "viol")
    oracle = {}
    for tag, qp, opts in (
            ("ipm60", qp64, None),
            ("ipm200", qp64, ipm.IpmOptions(max_iters=200, tol=1e-18)),
            ("ipm60_reg", [H + reg] + qp64[1:], None)):
        rows = chip_smoke.activeset_rows(qp, opts)
        oracle[tag] = [dict(zip(keys, r)) for r in rows]
    return {"genrows_plain": plain, "genrows_compensated": comp,
            "activeset": oracle}


def _divergence(run, tag):
    """max |x_f32 - x_f64| of ``run(dtype)``'s plant states, per state
    and per tick."""
    import numpy as np
    import torch
    xs = {}
    for dtype in (torch.float32, torch.float64):
        t0 = time.perf_counter()
        xs[dtype] = run(dtype).x_history.double().numpy()
        print(f"{tag} {dtype}: {time.perf_counter() - t0:.1f} s",
              file=sys.stderr)
    d = np.abs(xs[torch.float32] - xs[torch.float64])
    return {"per_state": d.max((0, 1)).tolist(),
            "per_tick": d.max((0, 2)).tolist()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("what", choices=("t64", "port-lap", "plan64",
                                     "divergence", "routes"))
    ap.add_argument("--ticks", type=int, default=20)
    ap.add_argument("--check", type=int, default=4)
    ap.add_argument("--nmpc", action="store_true")
    ap.add_argument("--raceline", metavar="PLAN.npz")
    ap.add_argument("--port", action="store_true")
    ap.add_argument("--nodes", type=int, default=160)
    ap.add_argument("--iters", type=int, default=40)
    ap.add_argument("--threads", type=int)
    ap.add_argument("--out", metavar="PLAN.npz")
    ap.add_argument("--only", nargs="+", metavar="KEY")
    ap.add_argument("--pod", metavar="POD.json")
    a = ap.parse_args()
    if a.what == "t64":
        res = t64()
    elif a.what == "port-lap":
        res = port_lap()
    elif a.what == "plan64":
        res = plan64(a.nodes, a.iters, a.port, a.threads, a.out)
    elif a.what == "routes":
        res = routes(a.check)
    else:
        res = divergence(a.ticks, a.check, a.nmpc, a.raceline, a.only,
                         a.pod)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
