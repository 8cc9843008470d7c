#!/usr/bin/env python3
"""Time the port's linearisation against a forward-mode candidate, in one
process on one card.

    python3 tools/linearisation_ab.py

The port linearises with ``vmap`` over the points of ``jacfwd`` of the
per-instance function (``integrators.linearize_discrete`` and
``constraints.linearize_group``).  The candidate, :func:`jacobians` here,
evaluates the function once on (nx, D, ...) copies of the points whose
forward-mode tangents are the D = nx + nu unit directions (the models read
and stack along the first axis, so they run on that layout; the friction
polygon's rows are broadcast by :func:`polygon_group`).  Each is swapped
in for the dynamic Riccati QP build, a warm LTV tick under ``F32_OPTS``
and an MS-NMPC tick under ``F32_PRODUCTION``, at B=1024 on fsg2019
(``chip_smoke.initial_batch``), CUDA events over 3 calls after one more,
in the order port, candidate, candidate, port; then the largest difference
of the two builds' StageQP fields; the times as one JSON line last.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jacobians(fn, x, u):
    """``fn(x, u)`` and its Jacobians in x and u at every point of ``x``
    (..., nx), ``u`` (..., nu), in one forward-mode pass; returns (y
    (..., ny), Jx (..., ny, nx), Ju (..., ny, nu)) in x's dtype."""
    import torch
    import torch.autograd.forward_ad as fwAD
    nx, nu = x.shape[-1], u.shape[-1]
    D, lead = nx + nu, x.shape[:-1]
    eye = torch.eye(D, dtype=x.dtype, device=x.device).reshape(
        (D, D) + (1,) * len(lead)).expand((D, D) + lead).contiguous()
    x_d = x.movedim(-1, 0)[:, None].expand((nx, D) + lead).contiguous()
    u_d = u.movedim(-1, 0)[:, None].expand((nu, D) + lead).contiguous()
    with fwAD.dual_level():
        out = fn(fwAD.make_dual(x_d, eye[:nx]),
                 fwAD.make_dual(u_d, eye[nx:]))
        y, t = fwAD.unpack_dual(out)
    y = y[:, 0].movedim(0, -1).to(x.dtype)
    J = t.movedim(0, -1).movedim(0, -1).to(x.dtype)
    return y, J[..., :nx], J[..., nx:]


def linearize_discrete(step, x_traj, u_traj, data=()):
    """The candidate for shared data (floats, one track) only."""
    y, Ad, Bd = jacobians(lambda x, u: step(x, u, *data), x_traj, u_traj)
    return Ad, Bd, (y - (Ad @ x_traj[..., None])[..., 0]
                    - (Bd @ u_traj[..., None])[..., 0])


def linearize_group(g_fn, x_lin, u_lin, lb, ub, slack_idx, state_rows=None,
                    ctrl_cols=None, data=()):
    import numpy as np
    import torch
    from fsae_mpc_tpu_torch.mpc.constraints import StageConstraint
    g0, C, D = jacobians(lambda x, u: g_fn(x, u, *data), x_lin, u_lin)
    Ng = x_lin.shape[-2]
    return StageConstraint(
        C=C, D=D,
        offset_const=(g0 - torch.einsum("...ri,...i->...r", C, x_lin)
                      - torch.einsum("...ri,...i->...r", D, u_lin)),
        lb=np.atleast_1d(np.asarray(lb, np.float64)),
        ub=np.atleast_1d(np.asarray(ub, np.float64)),
        slack_idx=np.atleast_1d(np.asarray(slack_idx, np.int32)),
        state_rows=np.asarray(np.arange(Ng) if state_rows is None
                              else state_rows, np.int32),
        ctrl_cols=np.asarray(np.arange(Ng) if ctrl_cols is None
                             else ctrl_cols, np.int32))


def polygon_group(x_lin, u_lin, mpc, params, slack):
    """``constraints.friction_polygon_group`` with its K rows broadcast
    over trailing dimensions."""
    import numpy as np
    import torch
    from fsae_mpc_tpu_torch.models import curvilinear as cm
    K = mpc.n_tyre_polygon
    theta = torch.linspace(0.0, 2.0 * math.pi, K + 1, dtype=x_lin.dtype,
                           device=x_lin.device)
    ac = params.ac_max * torch.sin(theta)
    al = params.al_max * torch.cos(theta)
    dac, dal = ac[1:] - ac[:-1], al[1:] - al[:-1]

    def g(x, u):
        col = lambda v: v.reshape((K,) + (1,) * u[0].ndim)
        fcr_norm = cm.rear_lateral_force(x, params) / params.m
        return ((u[0] - col(al[:-1])) * col(dac)
                - (fcr_norm - col(ac[:-1])) * col(dal))

    return linearize_group(g, x_lin, u_lin, np.full((K,), -np.inf),
                           np.zeros((K,)), np.full((K,), slack, np.int32))


def main() -> int:
    sys.path.insert(0, ROOT)
    import torch
    import chip_smoke as cs
    from fsae_mpc_tpu_torch.config import MPC_F32, VehicleParams
    from fsae_mpc_tpu_torch.models import integrators
    from fsae_mpc_tpu_torch.mpc import constraints as cons, ltv, sqp
    from fsae_mpc_tpu_torch.ops import ipm
    from fsae_mpc_tpu_torch.track import load_track

    names = ("linearize_discrete", "linearize_group",
             "friction_polygon_group")
    port = (integrators.linearize_discrete, cons.linearize_group,
            cons.friction_polygon_group)
    candidate = (linearize_discrete, linearize_group, polygon_group)

    def use(fns):
        integrators.linearize_discrete = fns[0]
        cons.linearize_group, cons.friction_polygon_group = fns[1:]

    card = cs.card_line()
    print("card:", card, "; port / candidate:", names, flush=True)
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    track, _ = load_track(os.path.join(ROOT, "data", "fsg2019.csv"),
                          dtype=torch.float32, device=device)
    params, mpc = VehicleParams(), MPC_F32
    xc, xl, ul = cs.initial_batch(1024, mpc, torch.float32, device)
    x_ref = cs.reference(xc, mpc)
    warm = ltv.ltv_mpc_dynamic(xc, x_ref, track, params, mpc, xl, ul,
                               ipm.F32_OPTS, backend="riccati").qp
    build = lambda: ltv.build_stage_qp_dynamic(xc, x_ref, track, params,
                                               mpc, xl, ul)[0]
    cases = {
        "QP build (dynamic Riccati)": build,
        "LTV tick (dynamic Riccati F32_OPTS, warm)":
            lambda: ltv.ltv_mpc_dynamic(xc, x_ref, track, params, mpc, xl,
                                        ul, ipm.F32_OPTS, warm=warm,
                                        backend="riccati"),
        "MS-NMPC tick (dynamic Riccati F32_PRODUCTION)":
            lambda: sqp.ms_nmpc_dynamic(xc, x_ref, track, params, mpc, xl,
                                        ul, ipm.F32_PRODUCTION,
                                        backend="riccati"),
    }
    res = {}
    try:
        for name, fn in cases.items():
            for label, fns in (("port", port), ("candidate", candidate),
                               ("candidate", candidate), ("port", port)):
                use(fns)
                res.setdefault(name, {}).setdefault(label, []).append(
                    cs.cuda_ms(fn, 3, warmup=1))
            print(f"{name}: port {res[name]['port']} ms, candidate "
                  f"{res[name]['candidate']} ms  ({card})", flush=True)
        use(port)
        a = build()
        use(candidate)
        b = build()
    finally:
        use(port)
    d = max(float((getattr(a, f.name) - getattr(b, f.name)).abs().max())
            for f in dataclasses.fields(a)
            if bool(torch.isfinite(getattr(a, f.name)).all()))
    print("max |port - candidate| over the finite StageQP fields:", d,
          flush=True)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
