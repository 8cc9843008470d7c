#!/usr/bin/env python3
"""Reference numbers for the closed-loop phases of ``chip_smoke.py``,
computed on a CPU.

    python3 tools/sim_reference.py t64
    python3 tools/sim_reference.py port-lap
    python3 tools/sim_reference.py divergence [--ticks 20] [--check 4]

``t64``: the JAX package's f64 lap of fsg2019 in the configuration of its
``tests/test_laps.py`` f32-equivalence test (dynamic model, dense backend,
``MPC_F32`` weights, ``IpmOptions(max_iters=30, adaptive=False)``, 700
ticks): lap time, ``lap_done`` and the violations.  It imports ``jax`` and
``fsae_mpc_tpu`` and so runs where they are installed, never on the card's
machine; ``chip_smoke.py`` pins the number it prints (``LAP_T64``).

``port-lap``: the same lap by the port on the CPU in f64
(``simulate_timed``, stopping when the lap is done).

``divergence``: the port's ``simulate`` on the CPU for ``chip_smoke.py``'s
phase-4 scenarios (instances 0..check-1 of ``sim_scenarios``) and
configurations, in f32 and in f64, and the largest |x_f32 - x_f64| over
the ticks per plant state: the floor below which the card's f32 laps
cannot be held to the CPU's.
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


def _summary(out, seconds, index=None):
    import numpy as np
    keys = ("lap_time", "lap_done", "track_violation", "max_track_violation",
            "tyre_violation", "abnormal_exit_frac", "mean_iters")
    pick = lambda v: np.asarray(v) if index is None else np.asarray(v)[index]
    d = {k: float(pick(getattr(out, k))) for k in keys}
    d["seconds"] = seconds
    return d


def divergence(ticks, check):
    import numpy as np
    import torch
    import chip_smoke
    from fsae_mpc_tpu_torch.config import MPC_F32, VehicleParams
    from fsae_mpc_tpu_torch.ops import ipm
    from fsae_mpc_tpu_torch.sim import SimConfig, simulate
    from fsae_mpc_tpu_torch.track import load_track

    x_init = chip_smoke.sim_scenarios(check)
    out = {}
    for model, backend, preset in chip_smoke.SIM_CONFIGS:
        cfg = SimConfig(model=model, qp_backend=backend, n_ticks=ticks,
                        mpc=MPC_F32, ipm=getattr(ipm, preset))
        xs = {}
        for dtype in (torch.float32, torch.float64):
            track, _ = load_track(TRACK, dtype=dtype, device="cpu")
            t0 = time.perf_counter()
            res = simulate(track, VehicleParams(), cfg,
                           torch.tensor(x_init, dtype=dtype))
            xs[dtype] = res.x_history.double().numpy()
            print(f"{model}/{backend}/{preset} {dtype}: "
                  f"{time.perf_counter() - t0:.1f} s", file=sys.stderr)
        d = np.abs(xs[torch.float32] - xs[torch.float64])
        out[model] = {"per_state": d.max((0, 1)).tolist(),
                      "per_tick": d.max((0, 2)).tolist()}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("what", choices=("t64", "port-lap", "divergence"))
    ap.add_argument("--ticks", type=int, default=20)
    ap.add_argument("--check", type=int, default=4)
    a = ap.parse_args()
    if a.what == "t64":
        res = t64()
    elif a.what == "port-lap":
        res = port_lap()
    else:
        res = divergence(a.ticks, a.check)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
