#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU and check it.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result lines):

  1. build    -- compile ``fsae_mpc_tpu_torch/csrc/riccati.cu`` with nvcc
                 into ``fsae_mpc_tpu_torch/build/`` (no download).
  2. kernels  -- each of the four Riccati kernels against its plain
                 PyTorch version on the same CUDA tensors, in f32, at the
                 main path's shapes (B=1024, N=40, nx=7, r=20, ns=4, K=5
                 and K=1) and at an odd batch (B=37, also for the other
                 template instances nx 5/9, ns 1); one instance with an
                 indefinite 2x2 pivot must come out NaN with its
                 neighbours finite.  Kernel and plain times (CUDA events).
  3. main path -- ``ltv_mpc_dynamic_riccati`` on fsg2019 with ``MPC_F32``:
                 one cold solve and 10 warm ticks at B=1024 under
                 ``F32_OPTS`` and then ``F32_PRODUCTION``; outputs finite,
                 launch counts equal to the IPM schedule, warm-tick time;
                 one more warm tick of each preset must not synchronise
                 with the host (``torch.cuda.set_sync_debug_mode``).
  4. accuracy -- first-control max and mean control error against a tight
                 f64 solve of the same QP data (the port's plain path, on
                 CPU tensors on purpose), beside the accuracy bars:
                 (a) the JAX package's accuracy regime (ACCURACY_TPU.json,
                     scripts/accuracy_onchip.py): 32 instances after three
                     f64 ticks, solved cold in f32 on the card --
                     F32_PRODUCTION must meet the bars;
                 (b) the last warm tick of phase 3, 64 instances --
                     F32_PRODUCTION must stay within ACC_GUARD.

The last three lines of standard output are the card's name and power
limit, one JSON object with the kernels, and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
B_MAIN, N_MAIN, NX, NU, R, NS = 1024, 40, 7, 2, 20, 4
WARM_TICKS = 10
ACC_SUBSET = 64
SEED = 0
# kernel vs plain version, normwise relative (max |k - p| / max |p|):
# both run the same f32 recursion over 40 stages; they differ in summation
# order and in nvcc's FMA contraction, ~1e-7 per operation, grown by the
# recursion's conditioning on this data.
KERNEL_RTOL = 1e-4
ACC_BARS = {"first_control_max": 1e-2, "mean_control": 1e-3}
# regime (a), the JAX package's own: 32 instances, three f64 ticks of
# history (max_iters=16, fixed), then a cold f32 solve
REC_BATCH, REC_TICKS = 32, 3
# regime (b), the warm f32 chain: the JAX package's f32 solver, given the
# same QP data on the CPU, lands at the same errors as the port, above the
# bars on a share of instances; this guard (10x the bars) catches a port
# that has gone wrong, not the solver's f32 floor.
ACC_GUARD = {"F32_PRODUCTION": (1e-1, 1e-2)}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
            else f"nvidia-smi gave nothing ({out.stderr.strip()})"
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"


class Fail(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise Fail(msg)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def kernel_inputs(Bsz, N, K, seed, device, nx=NX, ns=NS):
    """Seeded, moderately conditioned stage data at the main path's widths
    (positive row weights over six decades, as the IPM's Dr spans)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    Ad = np.eye(nx) + 0.05 * rng.standard_normal((Bsz, N, nx, nx))
    d = dict(
        Ad=Ad, Bd=0.1 * rng.standard_normal((Bsz, N, nx, NU)),
        C=rng.standard_normal((Bsz, N, R, nx)),
        D=rng.standard_normal((Bsz, N, R, NU)),
        Ws=np.zeros((Bsz, N, R, ns)),
        Dr=10.0 ** rng.uniform(-3.0, 3.0, (Bsz, N, R)),
        qbd=rng.uniform(0.1, 2.0, (Bsz, N, nx)),
        rbd=rng.uniform(0.1, 2.0, (Bsz, N, NU)),
        rx=rng.standard_normal((Bsz, K, N, nx)),
        ru=rng.standard_normal((Bsz, K, N, NU)),
        re=0.1 * rng.standard_normal((Bsz, K, N, nx)))
    d["Ws"][:, :, np.arange(2 * ns), np.arange(2 * ns) % ns] = \
        np.where(np.arange(2 * ns) < ns, 1.0, -1.0)
    d["Qb"] = np.eye(nx) * d["qbd"][..., None]
    d["Rb"] = np.eye(NU) * d["rbd"][..., None]
    d["M0"] = np.zeros((Bsz, N, nx, NU))
    return {k: torch.tensor(v, dtype=torch.float32, device=device)
            for k, v in d.items()}


def rel_err(a, b) -> float:
    import torch
    denom = float(torch.max(torch.abs(b)))
    return float(torch.max(torch.abs(a - b))) / max(denom, 1e-30)


def abs_err(a, b) -> float:
    import torch
    return float(torch.max(torch.abs(a - b)))


def compare(name, outs, refs, results, tag):
    import torch
    for o, r in zip(outs, refs):
        check(torch.isfinite(o).all().item(), f"{name} [{tag}]: non-finite")
    rel = max(rel_err(o, r) for o, r in zip(outs, refs))
    ab = max(abs_err(o, r) for o, r in zip(outs, refs))
    log(f"kernel {name:16s} [{tag}] max rel err {rel:.3e} (tol "
        f"{KERNEL_RTOL:.0e}), max abs err {ab:.3e}")
    check(rel <= KERNEL_RTOL, f"{name} [{tag}]: rel err {rel:.3e} > "
          f"{KERNEL_RTOL:.0e}")
    res = results.setdefault(name, {"max_abs_err": 0.0, "max_rel_err": 0.0})
    res["max_abs_err"] = max(res["max_abs_err"], ab)
    res["max_rel_err"] = max(res["max_rel_err"], rel)


def kernel_phase(kr, device, card):
    import torch
    results = {}
    # the main path's shapes, then (B=37) the other template instances:
    # nx 5/9 and ns 1 serve the kinematic and collocation controllers
    cases = [(B_MAIN, NS + 1, NX, NS), (B_MAIN, 1, NX, NS),
             (37, NS + 1, NX, NS)] + [
        (37, ns + 1, nx, ns) for nx in (5, 7, 9) for ns in (1, 4)
        if (nx, ns) != (NX, NS)]
    for Bsz, K, nx, ns in cases:
        tag = f"B={Bsz} K={K}" + ("" if (nx, ns) == (NX, NS)
                                  else f" nx={nx} ns={ns}")
        x = kernel_inputs(Bsz, N_MAIN, K, SEED + Bsz + K + nx, device, nx,
                          ns)
        fac_args = (x["Ad"], x["Bd"], x["Qb"], x["Rb"], x["M0"])
        asm_args = (x["C"], x["D"], x["Ws"], x["Dr"], x["qbd"], x["rbd"],
                    x["Ad"], x["Bd"])
        fac_k = kr.factor_cuda(*fac_args)
        fac_p = kr.factor_ref(*fac_args)
        asm_k = kr.assemble_factor_cuda(*asm_args)
        asm_p = kr.assemble_factor_ref(*asm_args)
        # the apply sweeps on the plain factorisation, so each kernel is
        # held against its own plain version on the same inputs
        app_args = (*asm_p[:3], x["Ad"], x["Bd"], asm_p[3])
        rhs = (x["rx"], x["ru"], x["re"])
        hw_k = kr.apply_bwd_cuda(*app_args, *rhs)
        hw_p = kr.apply_bwd_ref(*app_args, *rhs)
        fwd_k = kr.apply_fwd_cuda(*app_args, x["re"], *hw_p)
        fwd_p = kr.apply_fwd_ref(*app_args, x["re"], *hw_p)
        torch.cuda.synchronize()
        if K == ns + 1:
            compare("factor", fac_k, fac_p, results, tag)
            compare("assemble_factor", asm_k, asm_p, results, tag)
        compare("apply_bwd", hw_k, hw_p, results, tag)
        compare("apply_fwd", fwd_k, fwd_p, results, tag)
        if Bsz == B_MAIN:
            times = {
                "factor": (lambda: kr.factor_cuda(*fac_args),
                           lambda: kr.factor_ref(*fac_args)),
                "assemble_factor": (lambda: kr.assemble_factor_cuda(*asm_args),
                                    lambda: kr.assemble_factor_ref(*asm_args)),
                "apply_bwd": (lambda: kr.apply_bwd_cuda(*app_args, *rhs),
                              lambda: kr.apply_bwd_ref(*app_args, *rhs)),
                "apply_fwd": (
                    lambda: kr.apply_fwd_cuda(*app_args, x["re"], *hw_p),
                    lambda: kr.apply_fwd_ref(*app_args, x["re"], *hw_p)),
            }
            for name, (fk, fp) in times.items():
                if K == 1 and name in ("factor", "assemble_factor"):
                    continue
                ms = cuda_ms(fk, 20)
                pms = cuda_ms(fp, 3, warmup=1)
                log(f"time {name:16s} [{tag}] kernel {ms:.4f} ms, plain "
                    f"{pms:.4f} ms  ({card})")
                key = "" if K == NS + 1 else "_k1"
                results[name]["ms" + key] = ms
                results[name]["plain_ms" + key] = pms

    # NaN poison: instance 5 of 37 gets an indefinite pivot at stage 17
    x = kernel_inputs(37, N_MAIN, 1, SEED + 99, device)
    Rb = x["Rb"].clone()
    Rb[5, 17] = torch.tensor([[-5.0, 0.0], [0.0, 1.0]], device=device)
    for name, out in (
            ("factor", kr.factor_cuda(x["Ad"], x["Bd"], x["Qb"], Rb,
                                      x["M0"])),
            ("assemble_factor", kr.assemble_factor_cuda(
                x["C"], x["D"], x["Ws"], x["Dr"], x["qbd"],
                torch.where(torch.arange(37, device=device)[:, None, None]
                            == 5, -1e9, x["rbd"]), x["Ad"], x["Bd"]))):
        huinv = out[0]
        others = torch.ones(37, dtype=torch.bool, device=device)
        others[5] = False
        poisoned = bool(torch.isnan(huinv[5]).any())
        clean = all(bool(torch.isfinite(o[others]).all()) for o in out)
        log(f"kernel {name:16s} [NaN poison] instance 5 NaN: {poisoned}, "
            f"other 36 finite: {clean}")
        check(poisoned and clean, f"{name}: NaN poison not isolated")
    return results


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------


def initial_batch(Bsz, mpc, dtype, device):
    """The bench's batch (``bench.py``, ``scripts/accuracy_onchip.py``):
    instances spread over the first 100 m of fsg2019 at 8 m/s, linearised
    along a straight constant-speed guess."""
    import numpy as np
    import torch
    N = mpc.n_steps
    rng = np.random.default_rng(SEED)
    t = mpc.dt * np.arange(1, N + 1)
    x_lin = np.zeros((Bsz, N, 7))
    x_lin[:, :, 0] = 8.0 * t
    x_lin[:, :, 3] = 8.0
    x0 = np.zeros((Bsz, 7))
    x0[:, 0] = rng.uniform(0.0, 100.0, Bsz)
    x0[:, 1] = rng.uniform(-0.2, 0.2, Bsz)
    x0[:, 3] = 8.0
    as_t = lambda a: torch.tensor(a, dtype=dtype, device=device)
    return (as_t(x0), as_t(x_lin),
            torch.zeros((Bsz, N, 2), dtype=dtype, device=device))


def reference(x0, mpc):
    """Speed ramp to 20 m/s along the centreline from each instance's s."""
    import torch
    N = mpc.n_steps
    steps = torch.arange(1, N + 1, dtype=x0.dtype, device=x0.device)
    v = torch.clamp_max(x0[:, 3:4] + 10.0 * mpc.dt * steps, 20.0)
    x_ref = torch.zeros((x0.shape[0], N, 7), dtype=x0.dtype,
                        device=x0.device)
    x_ref[:, :, 3] = v
    x_ref[:, :, 0] = x0[:, 0:1] + torch.cumsum(v * mpc.dt, 1)
    return x_ref


def closed_loop_step(track, params, mpc):
    """The plant: one RK4 step of the dynamic model per instance."""
    from torch.func import vmap
    from fsae_mpc_tpu_torch.models import curvilinear as cm, integrators
    f = lambda x, u: cm.f_curv_dyn_only(x, u, track, params)
    return vmap(lambda x, u: integrators.rk4_step(f, x, u, mpc.dt))


def main_path(device, card, kres):
    import torch
    from fsae_mpc_tpu_torch.config import MPC_F32, VehicleParams
    from fsae_mpc_tpu_torch.mpc import ltv
    from fsae_mpc_tpu_torch.ops import ipm
    from fsae_mpc_tpu_torch.ops.kernels import riccati as kr
    from fsae_mpc_tpu_torch.track import load_track

    f32 = torch.float32
    mpc, params = MPC_F32, VehicleParams()
    track, _ = load_track(os.path.join(ROOT, "data", "fsg2019.csv"),
                          dtype=f32, device=device)
    step = closed_loop_step(track, params, mpc)
    make_ref = lambda x0: reference(x0, mpc)
    x0_t, x_lin_t, u_lin_t = initial_batch(B_MAIN, mpc, f32, device)
    # IPM iterations per solve and kernel launches per iteration / per cold
    # solve (init_solve: one factor + one apply)
    schedule = {}
    out = {}
    kr.reset_launches()
    for name, opts in (("F32_OPTS", ipm.F32_OPTS),
                       ("F32_PRODUCTION", ipm.F32_PRODUCTION)):
        iters = opts.max_iters + opts.refine_restart * opts.refine_iters
        ticks = 1 + WARM_TICKS
        exp = {"factor": 1, "assemble_factor": iters * ticks,
               "apply_bwd": 1 + 2 * iters * ticks,
               "apply_fwd": 1 + 2 * iters * ticks}
        for k, v in exp.items():
            schedule[k] = schedule.get(k, 0) + v
        before = kr.launches()

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x_ref = make_ref(x0_t)
        res = ltv.ltv_mpc_dynamic_riccati(x0_t, x_ref, track, params, mpc,
                                          x_lin_t, u_lin_t, opts)
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
        finite = [torch.isfinite(res.u_opt).all()]
        carry = (x0_t, res.x_opt, res.u_opt, res.qp)
        last = None
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        for _ in range(WARM_TICKS):
            xc, xl, ul, warm = carry
            x_ref = make_ref(xc)
            res = ltv.ltv_mpc_dynamic_riccati(xc, x_ref, track, params, mpc,
                                              xl, ul, opts, warm=warm)
            finite.append(torch.isfinite(res.u_opt).all())
            last = (xc, x_ref, xl, ul, res)
            carry = (step(xc, res.u_opt[:, 0]), res.x_opt, res.u_opt, res.qp)
        end.record()
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
        tick_ms = start.elapsed_time(end) / WARM_TICKS
        check(bool(torch.stack(finite).all()), f"{name}: non-finite u_opt")
        check(bool(torch.isfinite(carry[0]).all()),
              f"{name}: non-finite closed-loop state")
        got = {k: v - before[k] for k, v in kr.launches().items()}
        log(f"main path {name}: cold solve {cold_s:.3f} s (includes first "
            f"use), warm tick {tick_ms:.2f} ms (CUDA events; host "
            f"{1e3 * host_s / WARM_TICKS:.2f} ms), "
            f"{B_MAIN / (tick_ms / 1e3):.1f} solves/s at B={B_MAIN}  "
            f"({card})")
        log(f"main path {name}: launches {got}, schedule {exp}")
        check(got == exp, f"{name}: launches {got} != schedule {exp}")
        # per warm tick: one assemble_factor and a K=5 and a K=1 apply per
        # IPM iteration, at the kernel phase's per-launch times
        k_ms = iters * (kres["assemble_factor"]["ms"]
                        + kres["apply_bwd"]["ms"] + kres["apply_fwd"]["ms"]
                        + kres["apply_bwd"]["ms_k1"]
                        + kres["apply_fwd"]["ms_k1"])
        log(f"main path {name}: hand kernels ~{k_ms:.2f} ms of the "
            f"{tick_ms:.2f} ms warm tick ({100 * k_ms / tick_ms:.1f}%; "
            f"per-launch times x launches)")
        out[name] = dict(last=last, tick_ms=tick_ms)
    total = kr.launches()
    check(total == schedule, f"launches {total} != schedule {schedule}")
    # the tick's first layer alone: linearisation + constraint rows + QP
    xc, x_ref, xl, ul, _ = out["F32_OPTS"]["last"]
    build_ms = cuda_ms(lambda: ltv.build_stage_qp_dynamic(
        xc, x_ref, track, params, mpc, xl, ul), 3, warmup=1)
    log(f"main path: build_stage_qp_dynamic {build_ms:.2f} ms of the warm "
        f"tick at B={B_MAIN}  ({card})")
    check(all(v > 0 for v in total.values()), f"a kernel never ran: {total}")
    return out, total, (track, params, mpc)


def sync_check(out, model):
    """The f32 tick must not synchronise with the host (so that a later
    change can capture it in a CUDA graph): one more warm tick of each
    preset under ``torch.cuda.set_sync_debug_mode("warn")``."""
    import warnings
    import torch
    from fsae_mpc_tpu_torch.mpc import ltv
    from fsae_mpc_tpu_torch.ops import ipm, riccati

    track, params, mpc = model
    counts = {}
    for name, opts in (("F32_OPTS", ipm.F32_OPTS),
                       ("F32_PRODUCTION", ipm.F32_PRODUCTION)):
        xc, x_ref, xl, ul, res = out[name]["last"]
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                qp, _ = ltv.build_stage_qp_dynamic(xc, x_ref, track, params,
                                                   mpc, xl, ul)
                n_build = len(caught)
                riccati.solve_stage_qp(qp, opts, warm=res.qp)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        # the mode's own notice ("a prototype feature") is not a sync
        syncs = [i for i, w in enumerate(caught)
                 if "called a synchronizing" in str(w.message)]
        counts[name] = (sum(i < n_build for i in syncs),
                        sum(i >= n_build for i in syncs))
        sites = sorted({f"{os.path.relpath(caught[i].filename, ROOT)}:"
                        f"{caught[i].lineno}" for i in syncs})
        log(f"host syncs {name}: build_stage_qp_dynamic {counts[name][0]}, "
            f"solve_stage_qp {counts[name][1]}  {sites[:8]}")
    check(all(v == (0, 0) for v in counts.values()),
          f"the f32 tick synchronises with the host: {counts}")


# ---------------------------------------------------------------------------
# phase 4: accuracy against a tight f64 solve
# ---------------------------------------------------------------------------


def control_errors(tag, qp, u32, ref_u=None):
    """First-control max and mean control error of ``u32`` against a tight
    f64 solve of the same QP data (``ref_u``, or solved here on CPU
    tensors: the port's plain path, on purpose)."""
    import dataclasses
    import torch
    from fsae_mpc_tpu_torch.ops import ipm, riccati

    t0 = time.perf_counter()
    if ref_u is None:
        qp64 = riccati.StageQP(**{
            f.name: getattr(qp, f.name).detach().to("cpu", torch.float64)
            for f in dataclasses.fields(qp)})
        ref = riccati.solve_stage_qp(qp64, ipm.IpmOptions(max_iters=60))
        check(bool(torch.isfinite(ref.u).all()), f"{tag}: f64 reference "
              "non-finite")
        ref_u = ref.u
    solve_s = time.perf_counter() - t0
    du = (u32.detach().to("cpu", torch.float64) - ref_u).abs()
    fc, mean = float(du[:, 0].max()), float(du.mean())
    log(f"accuracy {tag}: first-control max {fc:.3e} (bar "
        f"{ACC_BARS['first_control_max']:.0e}), mean {mean:.3e} (bar "
        f"{ACC_BARS['mean_control']:.0e}); f64 reference {solve_s:.1f} s")
    return fc, mean, ref_u


def accuracy(out, model, device):
    import dataclasses
    import torch
    from fsae_mpc_tpu_torch.mpc import ltv
    from fsae_mpc_tpu_torch.ops import ipm, riccati

    track, params, mpc = model
    presets = {"F32_OPTS": ipm.F32_OPTS,
               "F32_PRODUCTION": ipm.F32_PRODUCTION}

    # (a) three ticks of f64 history on CPU tensors, then each preset's
    # cold f32 solve of the fourth tick's QP on the card
    f64, cpu = torch.float64, torch.device("cpu")
    track64 = track.to(cpu, f64)
    step = closed_loop_step(track64, params, mpc)
    xc, xl, ul = initial_batch(REC_BATCH, mpc, f64, cpu)
    hist = ipm.IpmOptions(max_iters=16, adaptive=False)
    for _ in range(REC_TICKS):
        res = ltv.ltv_mpc_dynamic_riccati(xc, reference(xc, mpc), track64,
                                          params, mpc, xl, ul, hist)
        xc, xl, ul = step(xc, res.u_opt[:, 0]), res.x_opt, res.u_opt
    qp64, _ = ltv.build_stage_qp_dynamic(xc, reference(xc, mpc), track64,
                                         params, mpc, xl, ul)
    qp32 = riccati.StageQP(**{
        f.name: getattr(qp64, f.name).to(device, torch.float32)
        for f in dataclasses.fields(qp64)})
    ref_u = None
    for name, opts in presets.items():
        u32 = riccati.solve_stage_qp(qp32, opts).u
        check(bool(torch.isfinite(u32).all()), f"{name}: non-finite u")
        fc, mean, ref_u = control_errors(
            f"{name} (a: {REC_BATCH} instances after {REC_TICKS} f64 ticks, "
            "cold f32 solve)", qp64, u32, ref_u)
        if name == "F32_PRODUCTION":
            check(fc <= ACC_BARS["first_control_max"]
                  and mean <= ACC_BARS["mean_control"],
                  f"{name}: accuracy {fc:.3e}/{mean:.3e} outside the bars")

    # (b) the last warm tick of the main path
    for name, d in out.items():
        xc, x_ref, xl, ul, res = d["last"]
        sub = slice(0, ACC_SUBSET)
        qp, _ = ltv.build_stage_qp_dynamic(xc[sub], x_ref[sub], track,
                                           params, mpc, xl[sub], ul[sub])
        fc, mean, _ = control_errors(
            f"{name} (b: warm tick {WARM_TICKS}, {ACC_SUBSET} instances)",
            qp, res.u_opt[sub])
        if name in ACC_GUARD:
            g_fc, g_mean = ACC_GUARD[name]
            check(fc <= g_fc and mean <= g_mean,
                  f"{name}: accuracy {fc:.3e}/{mean:.3e} outside the guard "
                  f"{g_fc:.0e}/{g_mean:.0e}")


def main() -> int:
    card = card_line()
    if not os.path.isdir(os.path.join(ROOT, "fsae_mpc_tpu_torch")):
        log(f"FAIL: no fsae_mpc_tpu_torch package beside {__file__}; run "
            "from a checkout of the repository")
        return 2
    import torch
    if not torch.cuda.is_available():
        log(f"FAIL: torch.cuda.is_available() is False (card: {card})")
        return 2
    sys.path.insert(0, ROOT)
    from fsae_mpc_tpu_torch.ops.kernels import riccati as kr

    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    try:
        t0 = time.perf_counter()
        lib = kr.build_library()
        log(f"build: {os.path.relpath(lib, ROOT)} in "
            f"{time.perf_counter() - t0:.1f} s")
        with open(lib[:-3] + ".log") as f:
            for line in f:
                if ("registers" in line or "spill" in line
                        or "Compiling entry" in line):
                    log("ptxas: " + line.strip())
        kres = kernel_phase(kr, device, card)
        out, launches, model = main_path(device, card, kres)
        sync_check(out, model)
        accuracy(out, model, device)
    except Fail as e:
        log(f"FAIL: {e}")
        return 1

    kernels = []
    for name, k in kr.KERNELS.items():
        kernels.append({
            "name": name, "route": "cuda",
            "source": "fsae_mpc_tpu_torch/csrc/riccati.cu",
            "replaces": k.replaces, "launches": launches[name],
            "max_abs_err": kres[name]["max_abs_err"],
            "ms": kres[name]["ms"], "plain_ms": kres[name]["plain_ms"]})
    print(card_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
