#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU and check it.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result lines):

  1. build    -- compile ``fsae_mpc_tpu_torch/csrc/{riccati,condense,
                 chol}.cu`` with nvcc, ``riccati.cu`` once more for each
                 of its planted faults (``-DRICCATI_PLANT=n``) and
                 ``chol.cu`` for each of its own (``-DCHOL_PLANT=n``), one
                 process per library, all started together, into
                 ``fsae_mpc_tpu_torch/build/``.
  2. kernels  -- each of the seven kernels against its plain PyTorch
                 version on the same CUDA tensors, in f32:
                 the four Riccati kernels at the Riccati path's shapes
                 (B=1024, N=40, nx=7, r=20, ns=4, K=5 and K=1), at the
                 kinematic QP's (nx=5, ns=1, r=6) and at the NMPC paths'
                 (``SHAPE_KEYS``: MS dynamic nx=7, ns=2, r=5, N=40;
                 trapezoidal on the augmented state, nz=9, ns=2, r=5 and
                 nz=7, ns=1, r=6, N=41), each also at an odd batch (B=37),
                 and at B=37 for every template instance (nx 5/7/9 by ns
                 1/2/4); condense at (B=1024, N=40, nx=7, nu=2) and
                 at B=37 with nx 7 and 5; the dense Cholesky factor and
                 solve at n=84, 81, 82 and 83 (the LTV and NMPC QPs), 163
                 (Hermite-Simpson: the six-slot build, past 48 KB of
                 shared memory) and 192 (the widest), B=1024 and B=37, on
                 SPD matrices
                 whose diagonal spans the IPM's range (up to its f32
                 complementarity cap, 1e7), normwise and entry by entry
                 (componentwise backward error, also of the solve on the
                 factor kernel's L; faults built on the data, the
                 factor's planted fault, a trailing-update tile skipped,
                 and the solve's, column 40's forward update skipped or
                 the back sweep reading columns for rows, and above n =
                 160 the factor's sixth slot left unwritten and the
                 solve's rows 160 on dropped from the back sweep, must
                 fail it).
                 factor, assemble_factor, apply_bwd and apply_fwd also
                 per instance and output block, and their planted faults
                 (a row dropped, a chunk staged one stage late, the P, p
                 or dx carry not advanced, two rhs swapped) must fail
                 those checks.  One indefinite instance among 37 must come
                 out NaN with its neighbours finite (Riccati 2x2 pivot,
                 at the main shapes and at nz=9, ns=2, N=41);
                 three indefinite dense KKT matrices (at n=84 and 163)
                 must come out NaN from their first failing pivot on and
                 finite before it, which the factor's planted pivot clamp
                 must fail; one instance
                 whose Huinv holds a NaN must come out NaN in apply_bwd and
                 apply_fwd with its neighbours finite.  Kernel times (CUDA
                 events around a CUDA graph of 20 launches, so host gaps
                 do not count), plain and library times, and each
                 kernel's bound.
  2b. entry  -- on the card, solve_stage_qp refuses an f64 and an nx=6
                 StageQP and solve_qp an f64 dense QP, an f32 one at
                 n=193 and the f64 planner's first QP under chol="auto",
                 each with a ValueError naming the route that runs it and
                 with every launch count still 0; a StageQP carried across
                 by interop.stage_qp with its defaults lands in f32 and
                 solves like the same data solved directly.
  3. main paths, each driven with every launch count set to 0 just
                 before it and read just after:
                 (a) ``ltv_mpc_dynamic(backend="riccati")`` and
                 (b) ``ltv_mpc_dynamic(backend="dense")`` (the default:
                 condense, condensed QP, dense IPM, rollout), on fsg2019
                 with ``MPC_F32``: one cold solve and 10 warm ticks at
                 B=1024 under ``F32_OPTS`` and then ``F32_PRODUCTION``;
                 outputs finite, launch counts equal to the IPM schedule,
                 warm-tick time, peak device memory; one more warm tick of
                 each preset must not synchronise with the host
                 (``torch.cuda.set_sync_debug_mode``).
  3b. accuracy -- first-control max and mean control error against a tight
                 f64 solve of the same QP data (the port's plain path, on
                 CPU tensors on purpose), beside the accuracy bars:
                 (a) the JAX package's accuracy regime (ACCURACY_TPU.json,
                     scripts/accuracy_onchip.py): 32 instances after three
                     f64 ticks, solved cold in f32 on the card by the
                     Riccati solver -- F32_PRODUCTION must meet the bars;
                 (b) the last warm tick of each main path, 64 instances --
                     F32_PRODUCTION must stay within ACC_GUARD;
                 (c) the dense and Riccati ticks on the same x0 and
                     linearisation solve the same QP: their first controls
                     side by side, in f32 on the card and in f64.
  4. closed loop -- ``sim.simulate`` at B=1024 laps of 20 ticks on
                 fsg2019 with ``MPC_F32``, kinematic/dense/``F32_ACCURATE``
                 and dynamic/Riccati/``F32_PRODUCTION``, from the origin
                 at rest with small seeded pose offsets: ms a sim tick
                 (CUDA events), peak memory, launch counts equal to the
                 schedule (no cold solve, so K4 never), no host
                 synchronisation inside ``simulate``, every trace finite,
                 and instances 0-3 against the port's own f32 run of the
                 same laps on the CPU (the plain versions) within
                 ``SIM_STATE_TOL``.
  5. timed lap -- ``sim.simulate_timed`` at B=1, dynamic/dense/
                 ``F32_ACCURATE``, until the lap of fsg2019 is done: lap
                 time within 0.20 s of the JAX package's f64 lap
                 (``LAP_T64``), track violation below 0.02, launch counts
                 equal to the schedule, and the tick times against the
                 50 ms budget.  Phase 2 also times K1-K3 and K5-K7 at the
                 kinematic QP's shapes (nx=5, ns=1, r=6; n=81).
  6. NMPC loop -- ``sim.simulate`` at B=1024 laps of 10 ticks with the
                 NMPC modes (``NMPC_CONFIGS``): MS dynamic/Riccati/
                 ``F32_PRODUCTION`` (K1 at ns=2, K4 once a tick), MS
                 kinematic/dense/``F32_ACCURATE`` (K5-K7, the pre-step
                 ellipse rows), trapezoidal dynamic/dense/``F32_ACCURATE``
                 (the non-aligned condensed QP, n=84), trapezoidal
                 kinematic/Riccati/``F32_PRODUCTION`` (nz=7, N=41) and
                 Hermite-Simpson kinematic/dense/``F32_ACCURATE`` (2N+1
                 points, n=163: K6/K7's six-slot build): as phase 4, with
                 launches equal to the schedule (three SQP subproblems a
                 tick, the first cold) and the tolerance from the
                 measured f32-to-f64 divergence of these laps
                 (``NMPC_STATE_TOL``).
  7. planner and raceline -- run right after phase 2b, so that the CPU's
                 laps on its plan run beside phases 3-6:
                 ``minimum_time_planner_dynamic`` in f64 on the card
                 (``chol="lapack"``, no kernel launched) at 160 nodes,
                 its lap time held to the JAX package's f64 CPU plan
                 (``PLAN_T64``), and at the JAX defaults (500 nodes, 40
                 SQP iterations), wall times printed; then, after phase
                 6, ``sim.simulate`` with ``reference="raceline"`` on the
                 500-node plan at B=1024 laps of 20 ticks, dynamic/
                 Riccati/``F32_PRODUCTION``, as phase 4 (launches equal
                 to the schedule, K4 0, no host sync, instances 0-3
                 against the CPU's f32 laps on the same plan within
                 ``RACELINE_STATE_TOL``).
  8. pod      -- the JAX package's pod-scale sweep (``scripts/pod_scale.py``,
                 BASELINE config 5): fsg2019, fso2020 and fss2019 stacked
                 into one batched track, each repeated for POD_VEHICLES
                 perturbed vehicles (``sim.batch.perturbed_params`` from a
                 seeded CUDA generator), B = 12,288 laps from rest at the
                 origin, dynamic/Riccati/``F32_PRODUCTION``, N=40, POD_TICKS
                 ticks through ``sim.checkpoint.run_chunked`` in chunks of
                 POD_CHUNK (``closed_loop.chunk_step``, a checkpoint after
                 each): launches equal to the schedule (K1-K3 above
                 B=1,024 for the first time, K4 0), no host
                 synchronisation inside a chunk, every trace and summary
                 finite; a run resumed from chunk 0's checkpoint
                 (``simulate_chunked``) and ``simulate`` of the same ticks
                 equal the chunked run bitwise; one Riccati LTV tick of the
                 batch against the same tick split over a mesh of the card
                 repeated three times (one shard per track,
                 ``check_shard_determinism``): the stage QPs bitwise equal,
                 the first controls parting no further than a last-digit
                 change of the inputs moves them (POD_QUANTILES); two
                 instances per track against the port's CPU f32 laps of
                 the same instances (run in a worker process beside phases
                 3-7) within ``POD_STATE_TOL``; ms a sim tick per chunk
                 (CUDA events), instance-ticks/s, peak device memory and
                 the metric summary reduced over the mesh
                 (``pmean_metrics``).

The last three lines of standard output are the card's name and power
limit, one JSON object with the kernels, and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import multiprocessing
import os
import subprocess
import sys
import time
from typing import NamedTuple

ROOT = os.path.dirname(os.path.abspath(__file__))
B_MAIN, N_MAIN, NX, NU, R, NS = 1024, 40, 7, 2, 20, 4
# rows a stage of the kinematic LTV QP (box [v, delta], track, lateral
# acceleration; the two soft groups emit a lower and an upper row each)
R_KIN = 6
# the Riccati kernels' shapes on the NMPC paths (nx, ns, rows a stage, N):
# multiple shooting, dynamic (box [x_d, delta], track, the friction
# ellipse's upper side: r = 5, slacks [track, tyre]); trapezoidal
# collocation on the augmented state z = [x; u] over N+1 stages, dynamic
# (nz = 9, the same rows) and kinematic (nz = 7, the kinematic rows); the
# kinematic MS QP has the kinematic LTV QP's shapes.  SHAPE_KEYS names
# each shape's times in the results ("" the main path's).
R_NMPC_DYN = 5
SHAPE_KEYS = {(NX, NS, R, N_MAIN): "", (5, 1, R_KIN, N_MAIN): "_kin",
              (7, 2, R_NMPC_DYN, N_MAIN): "_msdyn",
              (9, 2, R_NMPC_DYN, N_MAIN + 1): "_trdyn",
              (7, 1, R_KIN, N_MAIN + 1): "_trkin"}
WARM_TICKS = 10
ACC_SUBSET = 64
SEED = 0
# kernel vs plain version, normwise relative (max |k - p| / max |p|):
# both run the same f32 arithmetic (Riccati and condense: a recursion over
# 40 stages; Cholesky: 84 columns) in another summation order and with
# nvcc's FMA contraction, ~1e-7 per operation, grown by the recursion's or
# the matrix's conditioning on this data.
KERNEL_RTOL = 1e-4
# dense kernels: widths of the dynamic (nx=7, n=84) and kinematic (nx=5,
# n=81) LTV QPs, which the kinematic MS-NMPC and the dynamic trapezoidal
# QP share, of the dynamic MS-NMPC (n=82) and kinematic trapezoidal
# (n=83) QPs, of the Hermite-Simpson QP (n = (2N+1) nu + 1 = 163: the
# six-slot build, above 48 KB of shared memory) and the kernels' widest
# (n=192); DENSE_KEYS names each width's times in the results
N_DENSE = (84, 81, 82, 83, 163, 192)
DENSE_KEYS = {84: "", 81: "_kin", 82: "_n82", 83: "_n83", 163: "_hs",
              192: "_n192"}
# published peaks of one H100 SXM (NVIDIA data sheet, 700 W): HBM bytes/s
# and float32 operations/s outside the tensor cores
PEAK_BYTES, PEAK_F32 = 3.35e12, 67e12
ACC_BARS = {"first_control_max": 1e-2, "mean_control": 1e-3}
# regime (a), the JAX package's own: 32 instances, three f64 ticks of
# history (max_iters=16, fixed), then a cold f32 solve
REC_BATCH, REC_TICKS = 32, 3
# regime (b), the warm f32 chain: the JAX package's f32 solver, given the
# same QP data on the CPU, lands at the same errors as the port, above the
# bars on a share of instances; this guard (10x the bars) catches a port
# that has gone wrong, not the solver's f32 floor.
ACC_GUARD = {"F32_PRODUCTION": (1e-1, 1e-2)}
# phase 4, the batched closed loop: B_SIM laps of SIM_TICKS ticks in each
# (model, backend, preset) of SIM_CONFIGS on fsg2019 with MPC_F32, from
# the JAX package's start (the origin, at rest) offset per instance by
# SIM_OFFSETS (dx, dy in m, dtheta in rad; instance 0 unperturbed).  The
# first projection is warm-started at the initial guess's s = 0.0125 m,
# so the offsets stay small.
B_SIM, SIM_TICKS, SIM_CHECK = 1024, 20, 4


class Loop(NamedTuple):
    """One closed-loop configuration of phases 4, 6 and 7."""

    mode: str
    model: str
    backend: str
    preset: str
    transcription: str = "trapezoidal"
    reference: str = "speed_ramp"

    @property
    def key(self) -> str:
        """Its name in the tolerance tables: the model for LTV, "mode/model"
        for NMPC ("/hs" for Hermite-Simpson), "raceline/model"."""
        if self.reference == "raceline":
            return f"raceline/{self.model}"
        if self.mode == "ltv":
            return self.model
        return f"{self.mode}/{self.model}" + (
            "/hs" if self.transcription == "hs" else "")

    @property
    def tag(self) -> str:
        return (f"{'' if self.mode == 'ltv' else self.mode + ' '}"
                f"{'hs ' if self.transcription == 'hs' else ''}"
                f"{'raceline ' if self.reference == 'raceline' else ''}"
                f"{self.model}/{self.backend}/{self.preset}")

    def sim_config(self, ticks, mpc):
        from fsae_mpc_tpu_torch.ops import ipm
        from fsae_mpc_tpu_torch.sim import SimConfig
        return SimConfig(model=self.model, mode=self.mode,
                         qp_backend=self.backend, n_ticks=ticks, mpc=mpc,
                         ipm=getattr(ipm, self.preset),
                         transcription=self.transcription,
                         reference=self.reference)


SIM_CONFIGS = (Loop("ltv", "kinematic", "dense", "F32_ACCURATE"),
               Loop("ltv", "dynamic", "riccati", "F32_PRODUCTION"))
SIM_OFFSETS = (0.3, 0.3, 0.05)
# instances 0..SIM_CHECK-1 on the card against the same four laps run by
# the port on the CPU in f32 (the plain versions): max |x_card - x_cpu|
# over the ticks, per plant state [x, y, theta, x_d, y_d, theta_d,
# delta].  SIM_F32_DIVERGENCE is the f32-against-f64 divergence of the
# same laps and ticks on a CPU (``tools/sim_reference.py divergence``,
# x86-64): a reordering of f32 sums cannot be held closer than f32 itself
# comes to f64.  The tolerance is 5x that: two f32 runs may each lie that
# far from f64 on either side (2x), and the divergence grows ~1.5x a
# tick over the last ticks, so a run that parts a tick or two earlier
# shows up to ~2.5x more.
SIM_F32_DIVERGENCE = {
    "kinematic": (2.87e-06, 3.54e-05, 3.81e-05, 8.10e-06, 3.62e-04,
                  5.49e-04, 1.98e-04),
    "dynamic": (4.98e-04, 5.51e-03, 3.23e-03, 2.44e-03, 1.42e-02, 2.60e-02,
                8.03e-03)}
SIM_STATE_TOL = {k: tuple(5.0 * v for v in d)
                 for k, d in SIM_F32_DIVERGENCE.items()}
# phase 6, the NMPC closed loop: B_SIM laps of NMPC_TICKS ticks in each
# configuration of NMPC_CONFIGS on fsg2019 with MPC_F32, from phase 4's
# starts, three SQP iterations a tick.  Together they run every kernel and
# the NMPC assembly paths: K1 at ns=2 and K4 once a tick (the cold first
# subproblem; no warm start crosses ticks), the dense pre-step ellipse
# rows (non-aligned, n = 81), the trapezoidal condensed QP (non-aligned,
# NC = N+1, n = 84), the augmented-state stage QP (nz = 7, N+1 = 41
# stages) and Hermite-Simpson's condensed QP (2N+1 points, n = 163: K6
# and K7 in their six-slot build).  F32_ACCURATE is refused by the
# Riccati solver (scale_kkt, comp_resid), hence F32_PRODUCTION there.
NMPC_TICKS = 10
# instances 0..SIM_CHECK-1 against the same laps run by the port on the
# CPU in f32, as phase 4: NMPC_F32_DIVERGENCE is the f32-against-f64
# divergence of these laps and ticks on a CPU (``tools/sim_reference.py
# divergence --nmpc --ticks 10``, x86-64), the tolerance 5x that.  The
# plant's position error is a vector in the plane whose split between x
# and y follows the heading, so both coordinates take the larger of their
# two divergences (the kinematic MS laps' x alone diverges by 2.55e-7 m,
# two f32 units in the last place at the laps' ~1.3 m, where y diverges by
# 4.41e-6).
NMPC_F32_DIVERGENCE = {
    "ms-nmpc/dynamic": (1.24e-03, 3.57e-04, 3.18e-04, 3.45e-03, 1.34e-03,
                        2.20e-03, 1.67e-03),
    "ms-nmpc/kinematic": (2.55e-07, 4.41e-06, 4.66e-06, 5.97e-06, 6.82e-05,
                          1.07e-04, 6.63e-05),
    "c-nmpc/dynamic": (1.98e-06, 1.66e-05, 1.81e-05, 3.08e-05, 8.75e-05,
                       1.40e-04, 7.16e-05),
    "c-nmpc/kinematic": (4.45e-07, 1.45e-06, 1.77e-06, 3.33e-06, 1.24e-05,
                         2.14e-05, 8.46e-06),
    "c-nmpc/kinematic/hs": (1.79e-06, 6.64e-06, 7.37e-06, 7.61e-06,
                            2.83e-05, 4.96e-05, 2.76e-05)}
NMPC_STATE_TOL = {k: tuple(5.0 * v for v in (max(d[:2]),) * 2 + d[2:])
                  for k, d in NMPC_F32_DIVERGENCE.items()}
NMPC_CONFIGS = (Loop("ms-nmpc", "dynamic", "riccati", "F32_PRODUCTION"),
                Loop("ms-nmpc", "kinematic", "dense", "F32_ACCURATE"),
                Loop("c-nmpc", "dynamic", "dense", "F32_ACCURATE"),
                Loop("c-nmpc", "kinematic", "riccati", "F32_PRODUCTION"),
                Loop("c-nmpc", "kinematic", "dense", "F32_ACCURATE", "hs"))
# phase 5, one timed lap: B=1, dynamic / dense / MPC_F32 / F32_ACCURATE on
# fsg2019 from the origin at rest, at most LAP_TICKS ticks, stopping when
# the lap is done (the configuration of the JAX package's
# tests/test_laps.py test_f32_closed_loop_equivalence).  LAP_T64: the
# lap time of the same weights in f64 under IpmOptions(max_iters=30,
# adaptive=False), computed on a CPU by the JAX package
# (tools/sim_reference.py t64), since the card's machine has no JAX.
LAP_TICKS = 700
LAP_T64 = 21.25
LAP_TIME_TOL, LAP_TRACK_VIOLATION = 0.20, 0.02
# phase 7, the minimum-time planner and the raceline loop.  (1) The dynamic
# planner on fsg2019 in f64 on the card, its QPs factored by PyTorch's
# Cholesky (IpmOptions(chol="lapack"); the hand kernels take f32 and
# n <= 192): at the JAX package's defaults (PLAN_NODES = 500 nodes, 40 SQP
# iterations, friction_util 1.0; QPs of n = 4,002), the plan the raceline
# loop tracks, and at PLAN_REF_NODES = 160 nodes (the fewest at which the
# plan converges: at 96 its defect stays ~1.3 and its slacks ~0.8), held
# to PLAN_T64: the JAX package's f64 plan's lap time at 160 nodes on a CPU
# (tools/sim_reference.py plan64: the card's machine has no JAX, and a
# 500-node JAX plan takes ~3 h of CPU).  Its QPs stop at max_iters short
# of their tolerance, so the last digits of a summation order move the
# planner's path and the local optimum its 40 iterations end in: the
# port's f64 CPU plans with 4 and 1 intra-op threads end at 31.0093 and
# 33.1628 s.  PLAN_CPU_GAP is the larger gap between those and the JAX
# plan, PLAN_TIME_TOL 5x that; PLAN_DEFECT_MAX is 5x the largest defect
# of the three (0.0453, 0.0253, 0.0139), so that a plan that has not
# converged fails (at 96 nodes the defect stays ~1.3).  (2)
# ``simulate`` tracking that plan (reference="raceline") at B_SIM laps of
# RACELINE_TICKS ticks, dynamic/Riccati/F32_PRODUCTION from phase 4's
# starts, as phase 4: launches equal to the schedule (K4 0), no host
# synchronisation, instances 0-3 against the CPU's f32 laps on the same
# plan within 5x the f32-to-f64 divergence of those laps, x and y sharing
# the larger of their two as in phase 6 (tools/sim_reference.py
# divergence --raceline PLAN.npz --ticks 20, on the card's 500-node plan
# of a chip_smoke run, PLAN_OUT, one CPU thread, x86-64).
PLAN_NODES, PLAN_ITERS, PLAN_REF_NODES = 500, 40, 160
PLAN_T64 = 31.8096
PLAN_CPU_GAP = 1.3532
PLAN_TIME_TOL = 5.0 * PLAN_CPU_GAP
PLAN_DEFECT_MAX = 5.0 * 0.0453
RACELINE_CONFIG = Loop("ltv", "dynamic", "riccati", "F32_PRODUCTION",
                       reference="raceline")
RACELINE_TICKS = 20
RACELINE_F32_DIVERGENCE = {
    "raceline/dynamic": (5.38e-04, 2.09e-03, 1.50e-03, 1.88e-03, 2.42e-03,
                         6.24e-03, 1.40e-03)}
RACELINE_STATE_TOL = {k: tuple(5.0 * v for v in (max(d[:2]),) * 2 + d[2:])
                      for k, d in RACELINE_F32_DIVERGENCE.items()}
# phase 8, the pod-scale sweep: the JAX package's scripts/pod_scale.py at its
# defaults (4,096 vehicles x 3 tracks fitted at 100 segments, dynamic/
# Riccati, its "restart" preset = F32_PRODUCTION, N = 40, from rest at the
# origin, one CUDA generator's lognormal draws of m, Iz and pD per vehicle),
# cut in depth only: POD_TICKS ticks of its 1,000, to fit the run's time.
POD_TRACKS = ("fsg2019", "fso2020", "fss2019")
POD_VEHICLES, POD_TICKS, POD_CHUNK = 4096, 10, 5
POD_CONFIG = Loop("ltv", "dynamic", "riccati", "F32_PRODUCTION")
# the instances held to the CPU's f32 laps: the first two of each track
POD_CHECK = tuple(k * POD_VEHICLES + j for k in range(len(POD_TRACKS))
                  for j in (0, 1))
# their f32-against-f64 divergence on a CPU, per plant state, as phase 4's
# (tools/sim_reference.py divergence --pod POD.json --ticks 10, on the
# vehicles the card drew, which chip_smoke.py writes where POD_OUT names a
# file; one CPU thread, x86-64); the tolerance 5x that, x and y sharing
# the larger of their two as in phase 6.
POD_F32_DIVERGENCE = (8.95e-05, 4.75e-04, 5.44e-04, 7.25e-04, 5.64e-03,
                      9.42e-03, 3.97e-03)
POD_STATE_TOL = tuple(5.0 * v for v in (max(POD_F32_DIVERGENCE[:2]),) * 2
                      + POD_F32_DIVERGENCE[2:])
# one Riccati LTV tick of the batch against the same tick split into one
# shard per track.  The split must not change the QPs (their build is
# bitwise the same), but the solve cannot be held bitwise: a batched
# matrix-vector product over the B*N stages (einsum "bnri,bni->bnr" and
# "bnij,bnj->bni" in the IPM) gives a matrix in the last partial chunk of
# 65,535 another result, ~1 f32 unit, than the same matrix elsewhere, so
# the instances in those chunks differ (tools/batched_product_check.py:
# 1,641 of 12,288 with three shards on random data, one H100 with PyTorch
# 2.11 and CUDA 12.8), and a cold f32 IPM of 24 iterations amplifies that
# to O(1) in its worst-conditioned instances.
# So the shards' per-instance deviation is held, quantile by quantile over
# the instances, to the larger of the deviations that moving every
# instance's s0 one f32 unit up or down causes in the whole batch's tick.
POD_QUANTILES = (0.5, 0.9, 0.99, 0.999)
# the faults compiled into riccati.cu under -DRICCATI_PLANT=n, each of
# which the assemble_factor (1, 2), apply_fwd (3, 4), apply_bwd (5, 6) or
# factor (7, 8) checks must fail
PLANTS = {1: "assemble_factor drops row 3 of stage 17",
          2: "assemble_factor stages its second chunk one stage late",
          3: "apply_fwd does not advance the dx carry at stage 17",
          4: "apply_fwd swaps rhs 0 and 1 of instance 5",
          5: "apply_bwd does not advance the p carry at stage 17",
          6: "apply_bwd swaps rhs 0 and 1 of instance 5",
          7: "factor stages its second chunk one stage late",
          8: "factor does not advance P at stage 17"}
PLANT_KERNEL = {1: "assemble_factor", 2: "assemble_factor", 3: "apply_fwd",
                4: "apply_fwd", 5: "apply_bwd", 6: "apply_bwd", 7: "factor",
                8: "factor"}
# the faults compiled into chol.cu under -DCHOL_PLANT=n: (1, 3, 4, 5, 6) must
# fail the entrywise check of their kernel, (2) the NaN-poison check; 5 and
# 6 exist only in the six-slot build, so only from n = CHOL_PLANT_MIN_N on
CHOL_PLANTS = {1: "chol_factor skips one trailing-update tile in panel 2",
               2: "chol_factor clamps a non-positive pivot to 1e-6",
               3: "chol_solve skips column 40's update in the forward sweep",
               4: "chol_solve's back sweep reads column j in place of row j",
               5: "chol_factor's panel leaves its sixth slot unwritten",
               6: "chol_solve's back sweep drops rows 160 on from the "
                  "earlier panels"}
CHOL_PLANT_KERNEL = {1: "chol_factor", 2: "chol_factor", 3: "chol_solve",
                     4: "chol_solve", 5: "chol_factor", 6: "chol_solve"}
CHOL_PLANT_MIN_N = {5: 161, 6: 161}
# the dense NaN-poison case's indefinite instances (of 37)
CHOL_POISONED = (5, 9, 13)


def sim_scenarios(Bsz, seed=SEED):
    """Phase 4's initial plant states (Bsz, 7), numpy: the origin at rest,
    offset by dx, dy, dtheta drawn uniformly within SIM_OFFSETS; instance
    0 unperturbed."""
    import numpy as np
    rng = np.random.default_rng(seed)
    x = np.zeros((Bsz, 7))
    x[:, :3] = rng.uniform(-1.0, 1.0, (Bsz, 3)) * np.asarray(SIM_OFFSETS)
    x[0] = 0.0
    return x


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


def graph_ms(fn, reps: int = 20, replays: int = 5) -> float:
    """Device time of one call of ``fn``: ``reps`` calls captured in a
    CUDA graph, replayed ``replays`` times between CUDA events, so the
    host's time per call (wrapper, ctypes) leaves no gaps on the card."""
    import torch
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * replays)


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


def kernel_inputs(Bsz, N, K, seed, device, nx=NX, ns=NS, r=R,
                  dr_decades=6.0):
    """Seeded, moderately conditioned stage data at the main path's widths
    (positive row weights over ``dr_decades`` decades around 1, as the
    IPM's Dr spans)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    Ad = np.eye(nx) + 0.05 * rng.standard_normal((Bsz, N, nx, nx))
    d = dict(
        Ad=Ad, Bd=0.1 * rng.standard_normal((Bsz, N, nx, NU)),
        C=rng.standard_normal((Bsz, N, r, nx)),
        D=rng.standard_normal((Bsz, N, r, NU)),
        Ws=np.zeros((Bsz, N, r, ns)),
        Dr=10.0 ** rng.uniform(-0.5 * dr_decades, 0.5 * dr_decades,
                               (Bsz, N, r)),
        qbd=rng.uniform(0.1, 2.0, (Bsz, N, nx)),
        rbd=rng.uniform(0.1, 2.0, (Bsz, N, NU)),
        rx=rng.standard_normal((Bsz, K, N, nx)),
        ru=rng.standard_normal((Bsz, K, N, NU)),
        re=0.1 * rng.standard_normal((Bsz, K, N, nx)))
    d["Ws"][:, :, np.arange(2 * ns), np.arange(2 * ns) % ns] = \
        np.where(np.arange(2 * ns) < ns, 1.0, -1.0)
    d["Qb"] = np.eye(nx) * d["qbd"][..., None]
    d["Rb"] = np.eye(NU) * d["rbd"][..., None]
    d["M"] = 0.05 * rng.standard_normal((Bsz, N, nx, NU))
    return {k: torch.tensor(v, dtype=torch.float32, device=device)
            for k, v in d.items()}


def rel_err(a, b) -> float:
    import torch
    denom = float(torch.max(torch.abs(b)))
    return float(torch.max(torch.abs(a - b))) / max(denom, 1e-30)


def abs_err(a, b) -> float:
    import torch
    return float(torch.max(torch.abs(a - b)))


def inst_err(outs, refs) -> float:
    """The largest error of any instance in any output block, relative to
    that instance's own largest entry of the block (inf if non-finite):
    a fault confined to one instance or one block cannot hide behind the
    batch's scale."""
    import torch
    worst = 0.0
    for o, r in zip(outs, refs):
        if not bool(torch.isfinite(o).all()):
            return float("inf")
        d = (o - r).abs().flatten(1).amax(1)
        n = r.abs().flatten(1).amax(1).clamp_min(1e-30)
        worst = max(worst, float((d / n).max()))
    return worst


def compare(name, outs, refs, results, tag, per_instance=False):
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
    if per_instance:
        pi = inst_err(outs, refs)
        log(f"kernel {name:16s} [{tag}] per instance and block max rel err "
            f"{pi:.3e} (tol {KERNEL_RTOL:.0e})")
        check(pi <= KERNEL_RTOL, f"{name} [{tag}]: per-instance rel err "
              f"{pi:.3e} > {KERNEL_RTOL:.0e}")


def planted_faults(plants, cases, dims, tag):
    """Launch each planted-fault build of factor, assemble_factor,
    apply_fwd and apply_bwd on the case's inputs; each must fail the
    per-instance check against the plain outputs.  ``cases``: kernel
    name -> (inputs, plain outputs).  These launches count on no kernel's
    launch count."""
    import torch
    from fsae_mpc_tpu_torch.ops.kernels.build import Kernel
    Bsz, N, r, nx, ns, K = dims
    errs = {}
    for n, lib in plants.items():
        if n in (4, 6) and K < 2:
            continue                       # one rhs: nothing to swap
        name = PLANT_KERNEL[n]
        ins, refs = cases[name]
        sym = f"riccati_{name}_f32"
        ints = {"factor": (Bsz, N, nx),
                "assemble_factor": (Bsz, N, r, nx, ns)}.get(name,
                                                            (Bsz, K, N, nx))
        outs = tuple(torch.empty_like(t) for t in refs)
        lib.launch(Kernel(f"planted {n}", sym, ""), *ins, *outs, *ints)
        torch.cuda.synchronize()
        errs[n] = inst_err(outs, refs)    # >= the normwise error
    log(f"kernel {'riccati planted':16s} [{tag}] " + ", ".join(
        f"{n} ({PLANTS[n]}): {e:.3e}" for n, e in errs.items()))
    passed = [n for n, e in errs.items() if not e > KERNEL_RTOL]
    check(not passed, f"riccati [{tag}]: planted faults {passed} pass the "
          "checks")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(bytes_, ops):
    """The least time (ms) the card could take for the work, and which of
    the two limits sets it: the bytes moved at the HBM rate or the f32
    operations at the peak rate outside the tensor cores."""
    t_bytes, t_ops = bytes_ / PEAK_BYTES, ops / PEAK_F32
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def riccati_ops(name, B, N, nx, nu, r, ns, K):
    """Floating-point operations of one Riccati sweep (multiply-add = 2)."""
    stage = (4 * nx ** 3 + 6 * nx * nx * nu + 2 * nx * nx + nx * nu
             + 6 * nx * nu * nu + nu * nu + 10)
    fold = (2 * r * (nx * nx + nu * nu + nx * nu + nx * ns + nu * ns
                     + ns * ns) + r * (nx + nu + ns))
    per = {"factor": stage, "assemble_factor": stage + fold,
           "apply_bwd": (K * (4 * nx * nx + 6 * nx * nu + 4 * nx + nu)
                         + 2 * nu * nu * nx),
           "apply_fwd": K * (4 * nx * nx + 6 * nx * nu + 4 * nx
                             + 2 * nu * nu + nu)}[name]
    return B * N * per


def kernel_phase(kr, device, card, plants):
    import torch
    results = {}
    # (B, K, nx, ns, r, N): each shape of SHAPE_KEYS (the main path's,
    # the kinematic QP's, the NMPC paths') at B=1024 with K = ns+1 and
    # K = 1, and at B=37; then (B=37) every template instance at the main
    # rows (nx 5/7/9 by ns 1/2/4).  Five or six rows on nx + nu + ns >= 8
    # unknowns leave each stage's Gram block rank-deficient: with Dr over
    # six decades the plain version in f32 is itself 2.0e-4 normwise
    # (8.8e-4 per instance) from f64 on the r=6 data, where no 1e-4 check
    # of two f32 summation orders can hold; over three decades it is
    # 1.4e-6 (5.2e-6), the main case's conditioning (2.4e-6, 9.5e-6)
    cases = [(B_MAIN, k, nx, ns, r, n) for (nx, ns, r, n) in SHAPE_KEYS
             for k in (ns + 1, 1)] + [
        (37, ns + 1, nx, ns, r, n) for (nx, ns, r, n) in SHAPE_KEYS] + [
        (37, ns + 1, nx, ns, R, N_MAIN) for nx in kr.SUPPORTED_NX
        for ns in kr.SUPPORTED_NS if (nx, ns) != (NX, NS)]
    for Bsz, K, nx, ns, r, N in cases:
        tag = f"B={Bsz} K={K}" + ("" if (nx, ns) == (NX, NS)
                                  else f" nx={nx} ns={ns}") + (
            "" if r == R else f" r={r}") + ("" if N == N_MAIN else f" N={N}")
        x = kernel_inputs(Bsz, N, K, SEED + Bsz + K + nx, device, nx, ns,
                          r, 6.0 if r == R else 3.0)
        fac_args = (x["Ad"], x["Bd"], x["Qb"], x["Rb"], x["M"])
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
            compare("factor", fac_k, fac_p, results, tag, per_instance=True)
            compare("assemble_factor", asm_k, asm_p, results, tag,
                    per_instance=True)
        compare("apply_bwd", hw_k, hw_p, results, tag, per_instance=True)
        compare("apply_fwd", fwd_k, fwd_p, results, tag, per_instance=True)
        planted_faults(plants, {
            "factor": (fac_args, fac_p),
            "assemble_factor": (asm_args, asm_p),
            "apply_bwd": (app_args + rhs, hw_p),
            "apply_fwd": (app_args + (x["re"],) + tuple(hw_p), fwd_p)},
            (Bsz, N, r, nx, ns, K), tag)
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
            io = {"factor": (fac_args, fac_k),
                  "assemble_factor": (asm_args, asm_k),
                  "apply_bwd": (app_args + rhs, hw_k),
                  "apply_fwd": (app_args + (x["re"],) + tuple(hw_p), fwd_k)}
            for name, (fk, fp) in times.items():
                if K == 1 and name in ("factor", "assemble_factor"):
                    continue
                ms = graph_ms(fk)
                eager = cuda_ms(fk, 20)
                pms = cuda_ms(fp, 3, warmup=1)
                ins, outs = io[name]
                bms, by = bound(nbytes(*ins, *outs), riccati_ops(
                    name, Bsz, N, nx, NU, r, ns, K))
                log(f"time {name:16s} [{tag}] kernel {ms:.4f} ms (eager "
                    f"loop {eager:.4f} ms), plain {pms:.4f} ms, bound "
                    f"{bms:.4f} ms ({by}); no single PyTorch call computes "
                    f"it  ({card})")
                key = (SHAPE_KEYS[nx, ns, r, N]
                       + ("" if K == ns + 1 else "_k1"))
                results[name].update({"ms" + key: ms, "plain_ms" + key: pms,
                                      "bound_ms" + key: bms,
                                      "bound_by" + key: by})
                results[name]["library_ms"] = None

    # NaN poison: instance 5 of 37 gets an indefinite pivot at stage 17
    # (the main shapes, and the trapezoidal dynamic QP's: nz=9, ns=2, N=41)
    for nx, ns, r, N in ((NX, NS, R, N_MAIN),
                         (9, 2, R_NMPC_DYN, N_MAIN + 1)):
        x = kernel_inputs(37, N, 1, SEED + 99, device, nx, ns, r)
        Rb = x["Rb"].clone()
        Rb[5, 17] = torch.tensor([[-5.0, 0.0], [0.0, 1.0]], device=device)
        for name, out in (
                ("factor", kr.factor_cuda(x["Ad"], x["Bd"], x["Qb"], Rb,
                                          x["M"])),
                ("assemble_factor", kr.assemble_factor_cuda(
                    x["C"], x["D"], x["Ws"], x["Dr"], x["qbd"],
                    torch.where(torch.arange(37, device=device)[:, None,
                                                                None]
                                == 5, -1e9, x["rbd"]), x["Ad"], x["Bd"]))):
            huinv = out[0]
            others = torch.ones(37, dtype=torch.bool, device=device)
            others[5] = False
            poisoned = bool(torch.isnan(huinv[5]).any())
            clean = all(bool(torch.isfinite(o[others]).all()) for o in out)
            log(f"kernel {name:16s} [NaN poison, nx={nx} ns={ns} N={N}] "
                f"instance 5 NaN: {poisoned}, other 36 finite: {clean}")
            check(poisoned and clean, f"{name}: NaN poison not isolated")

    # apply_bwd and apply_fwd: instance 5 of 37 carries a NaN Huinv at
    # stage 17
    for K in (NS + 1, 1):
        x = kernel_inputs(37, N_MAIN, K, SEED + 98 + K, device)
        fac = kr.assemble_factor_ref(x["C"], x["D"], x["Ws"], x["Dr"],
                                     x["qbd"], x["rbd"], x["Ad"], x["Bd"])
        args = (*fac[:3], x["Ad"], x["Bd"], fac[3])
        hw = kr.apply_bwd_ref(*args, x["rx"], x["ru"], x["re"])
        Huinv = fac[0].clone()
        Huinv[5, 17] = float("nan")
        others = torch.ones(37, dtype=torch.bool, device=device)
        others[5] = False
        for name, out in (
                ("apply_bwd", kr.apply_bwd_cuda(Huinv, *args[1:], x["rx"],
                                                x["ru"], x["re"])),
                ("apply_fwd", kr.apply_fwd_cuda(Huinv, *args[1:], x["re"],
                                                *hw))):
            poisoned = all(bool(torch.isnan(o[5]).any()) for o in out)
            clean = all(bool(torch.isfinite(o[others]).all()) for o in out)
            log(f"kernel {name:16s} [NaN Huinv, K={K}] instance 5 NaN: "
                f"{poisoned}, other 36 finite: {clean}")
            check(poisoned and clean, f"{name} K={K}: NaN not isolated")
    return results


def spd_inputs(Bsz, n, seed, device):
    """Seeded SPD matrices M M'/n + I + diag(d) with d spanning the dense
    IPM's complementarity diagonals (1e-1 .. 1e7, the f32 cap), and a
    right-hand side."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((Bsz, n, n))
    d = 10.0 ** rng.uniform(-1.0, 7.0, (Bsz, n))
    K = (M @ np.swapaxes(M, -1, -2) / n + np.eye(n)
         + d[:, :, None] * np.eye(n))
    b = rng.standard_normal((Bsz, n))
    return (torch.tensor(K, dtype=torch.float32, device=device),
            torch.tensor(b, dtype=torch.float32, device=device))


def chol_backward(L_p, x_p):
    """The componentwise backward errors of a factor and of a solution,
    held against the plain factor L_p and solution x_p, in f64: a factor
    L by L L' against L_p L_p', relative to |L_p||L_p'| per entry; a
    solution x by L_p L_p' (x - x_p), relative to |L_p||L_p'||x_p| per
    row.  Returns the two functions."""
    import torch
    Lp = L_p.double()
    LL, absLL = torch.bmm(Lp, Lp.mT), torch.bmm(Lp.abs(), Lp.abs().mT)

    def fac(L):
        L = L.double()
        return float(((torch.bmm(L, L.mT) - LL).abs() / absLL).max())

    def sol(x):
        e = (x.double() - x_p.double())[..., None]
        den = torch.bmm(absLL, x_p.double().abs()[..., None])
        return float((torch.bmm(LL, e).abs() / den).max())

    return fac, sol


def chol_entrywise(K, b, L_k, L_p, x_k, x_p, x_kk, tag, planted=None,
                   planted_x=None):
    """K6 and K7 against their plain versions entry by entry, each entry at
    its own scale.  K's diagonal spans 1e-1..1e7, so the normwise check
    (max |k - p| / max |p|) allows every entry of L an error near 0.3 and
    every entry of x one near 1e-4 max|x|: far more than the sub-diagonal
    of L and the x of the heavy rows hold.  Here the componentwise backward
    errors of Cholesky and of the two triangular solves
    (:func:`chol_backward`), which are below ~(3n+1) u for any right f32
    kernel (u = 6e-8; Higham, Accuracy and Stability of Numerical
    Algorithms, Thms 10.3-10.4), hold K6's L, K7's x on the plain L, and
    K7's ``x_kk`` on K6's L.  Faults built on the same data, the factors
    of the planted builds of K6 (``planted``: fault -> L) and the
    solutions of those of K7 on the plain L (``planted_x``: fault -> x),
    must fail it."""
    import torch
    fac, sol = chol_backward(L_p, x_p)
    Kd = torch.diagonal(K, dim1=-2, dim2=-1)
    errs = {"chol_factor": fac(L_k), "chol_solve": sol(x_k),
            "chol_solve on K6's L": sol(x_kk)}
    faults = {
        "factor, sub-diagonal zeroed": fac(torch.diag_embed(
            torch.diagonal(L_p, dim1=-2, dim2=-1))),
        "factor, left-looking update skipped": fac(
            torch.tril(K) * torch.rsqrt(Kd)[:, None, :]),
        "solve, off-diagonal terms dropped where K_ii >= 1e4": sol(
            torch.where(Kd >= 1e4, b / Kd, x_p)),
    }
    faults.update({f"planted {n} ({CHOL_PLANTS[n]})": fac(L)
                   for n, L in (planted or {}).items()})
    faults.update({f"planted {n} ({CHOL_PLANTS[n]})": sol(x)
                   for n, x in (planted_x or {}).items()})
    for name, err in errs.items():
        log(f"kernel {name:16s} [{tag}] entrywise backward err {err:.3e} "
            f"(tol {KERNEL_RTOL:.0e})")
        check(err <= KERNEL_RTOL, f"{name} [{tag}]: entrywise err "
              f"{err:.3e} > {KERNEL_RTOL:.0e}")
    log(f"kernel {'chol planted':16s} [{tag}] " + ", ".join(
        f"{k}: {v:.3e}" for k, v in faults.items()))
    check(all(v > KERNEL_RTOL for v in faults.values()),
          f"chol [{tag}]: a planted fault passes the entrywise check")


def chol_planted(lib, K):
    """K6's planted build on K (a launch that no kernel's count
    records)."""
    import torch
    from fsae_mpc_tpu_torch.ops.kernels.build import Kernel
    L = torch.empty_like(K)
    lib.launch(Kernel("planted", "chol_factor_f32", ""), K, L, K.shape[0],
               K.shape[-1])
    return L


def chol_planted_solve(lib, L, b):
    """K7's planted build on (L, b) (a launch that no kernel's count
    records)."""
    import torch
    from fsae_mpc_tpu_torch.ops.kernels.build import Kernel
    x = torch.empty_like(b)
    lib.launch(Kernel("planted", "chol_solve_f32", ""), L, b, x, b.shape[0],
               b.shape[-1])
    return x


def chol_poison_inputs(device, n=N_DENSE[0]):
    """37 SPD matrices (n x n) of which three are indefinite
    (``CHOL_POISONED``): instance 5 from its first pivot on (K - 1e8 I),
    instance 9 from pivot 40, instance 13 from pivot n - 2 (in the last
    panel; at n = 163 in the six-slot build's sixth slot)."""
    import torch
    K, b = spd_inputs(37, n, SEED + 99, device)
    K[5] -= 1e8 * torch.eye(n, device=device)
    K[9, 40, 40] = -1e9
    K[13, n - 2, n - 2] = -1e9
    return K, b


def chol_poisoned(K, L, x):
    """(exact, clean) for the poison case: ``exact`` when each indefinite
    instance's L is finite in the columns before its first non-positive
    pivot (as ``cholesky_ex`` reports it on the same K) and NaN in every
    entry of the lower triangle from that column on, and its x is all
    NaN; ``clean`` when every other instance is finite."""
    import torch
    info = torch.linalg.cholesky_ex(K.double())[1]
    n = K.shape[-1]
    col = torch.arange(n, device=K.device)
    lower = col[:, None] >= col[None, :]
    exact, clean = True, True
    for i in range(K.shape[0]):
        f = int(info[i]) - 1
        if f < 0:
            clean &= bool(torch.isfinite(L[i]).all()) and bool(
                torch.isfinite(x[i]).all())
            continue
        after = lower & (col[None, :] >= f)
        exact &= (bool(torch.isfinite(L[i][:, :f]).all())
                  and bool(torch.isnan(L[i][after]).all())
                  and bool(torch.isnan(x[i]).all()))
    return exact, clean


def dense_kernel_phase(device, card, chol_plants):
    """Condense (K5) and the dense Cholesky factor and solve (K6, K7)
    against their plain versions; ``chol_plants``: fault -> the library
    of K6's planted build."""
    import numpy as np
    import torch
    from fsae_mpc_tpu_torch.ops.kernels import chol as kc
    from fsae_mpc_tpu_torch.ops.kernels import condense as kcd

    results = {}
    for Bsz, nx in ((B_MAIN, NX), (B_MAIN, 5), (37, NX), (37, 5)):
        tag = f"B={Bsz} nx={nx}"
        rng = np.random.default_rng(SEED + Bsz + nx)
        as_t = lambda a: torch.tensor(a, dtype=torch.float32, device=device)
        Ad = as_t(np.eye(nx) + 0.05 * rng.standard_normal((Bsz, N_MAIN, nx,
                                                            nx)))
        Bd = as_t(0.1 * rng.standard_normal((Bsz, N_MAIN, nx, NU)))
        dd = as_t(0.1 * rng.standard_normal((Bsz, N_MAIN, nx)))
        out_k = kcd.condense_cuda(Ad, Bd, dd)
        out_p = kcd.condense_ref(Ad, Bd, dd)
        torch.cuda.synchronize()
        compare("condense", out_k, out_p, results, tag)
        if Bsz == B_MAIN:
            ms = graph_ms(lambda: kcd.condense_cuda(Ad, Bd, dd))
            pms = cuda_ms(lambda: kcd.condense_ref(Ad, Bd, dd), 3, warmup=1)
            ops = Bsz * N_MAIN * 2 * nx * nx * (N_MAIN * NU + nx + 1)
            bms, by = bound(nbytes(Ad, Bd, dd, *out_k), ops)
            log(f"time {'condense':16s} [{tag}] kernel {ms:.4f} ms, plain "
                f"{pms:.4f} ms, bound {bms:.4f} ms ({by}); no single "
                f"PyTorch call computes it  ({card})")
            key = "" if nx == NX else "_kin"
            results["condense"].update({
                "ms" + key: ms, "plain_ms" + key: pms, "bound_ms" + key: bms,
                "bound_by" + key: by, "library_ms" + key: None})

    for n in N_DENSE:
        for Bsz in (B_MAIN, 37):
            tag = f"B={Bsz} n={n}"
            K, b = spd_inputs(Bsz, n, SEED + Bsz + n, device)
            L_k = kc.factor_cuda(K)
            # cholesky_ex gives a column-major factor; the kernels take the
            # row-major layout of their own outputs
            L_p = kc.factor_ref(K).contiguous()
            # the solve on the plain factor, so each kernel is held against
            # its own plain version on the same inputs
            x_k = kc.solve_cuda(L_p, b)
            x_p = kc.solve_ref(L_p, b)
            x_kk = kc.solve_cuda(L_k, b)
            plants = [p for p in CHOL_PLANTS
                      if n >= CHOL_PLANT_MIN_N.get(p, 0)]
            planted = {p: chol_planted(chol_plants[p], K) for p in plants
                       if CHOL_PLANT_KERNEL[p] == "chol_factor" and p != 2}
            planted_x = {p: chol_planted_solve(chol_plants[p], L_p, b)
                         for p in plants
                         if CHOL_PLANT_KERNEL[p] == "chol_solve"}
            torch.cuda.synchronize()
            compare("chol_factor", (L_k,), (L_p,), results, tag)
            compare("chol_solve", (x_k,), (x_p,), results, tag)
            chol_entrywise(K, b, L_k, L_p, x_k, x_p, x_kk, tag, planted,
                           planted_x)
            if Bsz != B_MAIN:
                continue
            tri = n * (n + 1) // 2
            cases = {
                # the lower triangle of K in, the full L out
                "chol_factor": (
                    lambda: kc.factor_cuda(K), lambda: kc.factor_ref(K),
                    lambda: torch.linalg.cholesky_ex(K),
                    "torch.linalg.cholesky_ex",
                    4 * Bsz * (tri + n * n), Bsz * n ** 3 / 3),
                # the lower triangle of L and b in, x out
                "chol_solve": (
                    lambda: kc.solve_cuda(L_p, b),
                    lambda: kc.solve_ref(L_p, b),
                    lambda: torch.cholesky_solve(b[..., None], L_p),
                    "torch.cholesky_solve",
                    4 * Bsz * (tri + 2 * n), Bsz * 2 * n * n),
            }
            for name, (fk, fp, fl, lib, nb, ops) in cases.items():
                ms = graph_ms(fk)
                pms = cuda_ms(fp, 10)
                lms = cuda_ms(fl, 10)
                bms, by = bound(nb, ops)
                log(f"time {name:16s} [{tag}] kernel {ms:.4f} ms, plain "
                    f"{pms:.4f} ms, {lib} {lms:.4f} ms, bound {bms:.4f} ms "
                    f"({by})  ({card})")
                key = DENSE_KEYS[n]
                results[name].update({
                    "ms" + key: ms, "plain_ms" + key: pms,
                    "library_ms" + key: lms, "bound_ms" + key: bms,
                    "bound_by" + key: by})

    # NaN poison: instances CHOL_POISONED of 37 are indefinite, at the main
    # width and at Hermite-Simpson's; planted fault 2 must fail the same
    # check
    for n in (N_DENSE[0], 163):
        K, b = chol_poison_inputs(device, n)
        L = kc.factor_cuda(K)
        exact, clean = chol_poisoned(K, L, kc.solve_cuda(L, b))
        log(f"kernel {'chol_factor/solve':16s} [NaN poison, n={n}] "
            f"instances {CHOL_POISONED} NaN from their first failing pivot "
            f"on: {exact}, the other {37 - len(CHOL_POISONED)} finite: "
            f"{clean}")
        check(exact and clean, f"chol n={n}: NaN poison not isolated")
        L = chol_planted(chol_plants[2], K)
        exact, clean = chol_poisoned(K, L, kc.solve_cuda(L, b))
        log(f"kernel {'chol planted':16s} [NaN poison, n={n}] 2 "
            f"({CHOL_PLANTS[2]}): "
            f"{'fails' if not (exact and clean) else 'PASSES'} the check")
        check(not (exact and clean), f"chol n={n}: planted fault 2 passes "
              "the NaN-poison check")
    return results


# ---------------------------------------------------------------------------
# phase 2b: the solvers' entry check on the card
# ---------------------------------------------------------------------------


def entry_phase(model, device):
    """On the card, ``solve_stage_qp`` and ``solve_qp`` refuse what their
    kernels cannot run before any launch (every launch count stays 0), with
    a ``ValueError`` that names the route that runs it: an f64 and an nx=6
    StageQP, an f64 dense QP and an f32 one wider than the kernels take
    (n = MAX_N + 1) under ``chol="auto"``, and the f64 planner's first QP
    under the default ``IpmOptions`` (the planner does not switch route on
    its own).  And a StageQP carried
    across from numpy (as the JAX package hands it over, here in f64) with
    ``interop.stage_qp``'s defaults lands on the card in f32 and solves,
    equal to the same data solved directly."""
    import dataclasses
    import torch
    from fsae_mpc_tpu_torch import interop
    from fsae_mpc_tpu_torch.mpc import ltv
    from fsae_mpc_tpu_torch.ops import ipm, riccati
    from fsae_mpc_tpu_torch.ops.kernels import chol as kc
    from fsae_mpc_tpu_torch.planner import minimum_time_planner_dynamic

    track, params, mpc = model
    wide = kc.MAX_N + 1
    eye = torch.eye(wide, device=device).expand(2, wide, wide).contiguous()
    zero = torch.zeros((2, wide), device=device)
    wide_qp = (eye, zero, torch.ones((2, 1, wide), device=device), zero - 1,
               zero + 1, zero[:, :1] - 1, zero[:, :1] + 1)
    xc, xl, ul = initial_batch(8, mpc, torch.float32, device)
    x_ref = reference(xc, mpc)
    sqp = ltv.build_stage_qp_dynamic(xc, x_ref, track, params, mpc, xl,
                                     ul)[0]
    dqp = ltv.build_qp_dynamic(xc, x_ref, track, params, mpc, xl, ul)[0]
    f64 = lambda q: dataclasses.replace(q, **{
        f.name: getattr(q, f.name).double() for f in dataclasses.fields(q)})
    nx6 = dataclasses.replace(sqp, Ad=sqp.Ad[..., :6, :6].contiguous(),
                              **{f: getattr(sqp, f)[..., :6].contiguous()
                                 for f in ("dd", "x0", "Qx", "qx")},
                              Bd=sqp.Bd[..., :6, :].contiguous(),
                              C=sqp.C[..., :6].contiguous())
    refusals = {
        "solve_stage_qp, f64 StageQP": (
            lambda: riccati.solve_stage_qp(f64(sqp), ipm.F32_OPTS),
            'device="cpu"'),
        "solve_stage_qp, nx=6 StageQP": (
            lambda: riccati.solve_stage_qp(nx6, ipm.F32_OPTS),
            'device="cpu"'),
        'solve_qp, f64 dense QP, chol="auto"': (
            lambda: ipm.solve_qp(*[t.double() for t in dqp[:7]],
                                 ipm.F32_OPTS), 'chol="lapack"'),
        f'solve_qp, f32 dense QP at n={wide}, chol="auto"': (
            lambda: ipm.solve_qp(*wide_qp, ipm.F32_OPTS), 'chol="lapack"'),
        'minimum_time_planner_dynamic, f64, default IpmOptions': (
            lambda: minimum_time_planner_dynamic(
                track.to(dtype=torch.float64), params, n_nodes=16, iters=1),
            'chol="lapack"'),
    }
    torch.cuda.synchronize()
    for what, (call, route) in refusals.items():
        reset_launches()
        try:
            call()
            msg = None
        except ValueError as e:
            msg = str(e)
        got = launches()
        log(f"entry {what}: {'refused' if msg else 'NOT refused'}, launches "
            f"{sum(got.values())}: {msg}")
        check(msg is not None and route in msg,
              f"entry check: {what} not refused naming {route}")
        check(not any(got.values()), f"entry check: {what} launched {got}")
    src = interop.to_numpy(f64(sqp))
    qp = interop.stage_qp(src)
    check(qp.Ad.dtype == torch.float32 and qp.Ad.device.type == "cuda",
          f"interop.stage_qp default: {qp.Ad.dtype} on {qp.Ad.device}")
    u = riccati.solve_stage_qp(qp, ipm.F32_OPTS).u
    u_direct = riccati.solve_stage_qp(sqp, ipm.F32_OPTS).u
    diff = float((u - u_direct).abs().max())
    log(f"entry interop.stage_qp(f64 numpy) with its defaults: "
        f"{qp.Ad.dtype} on {qp.Ad.device}, solved, max |u - u_direct| "
        f"{diff:.3e}")
    check(bool(torch.isfinite(u).all()) and diff <= KERNEL_RTOL * max(
        1.0, float(u_direct.abs().max())),
          "interop.stage_qp's default StageQP does not solve like the same "
          "data on the card")


# ---------------------------------------------------------------------------
# phase 3: the main paths
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


def kernel_modules():
    from fsae_mpc_tpu_torch.ops.kernels import chol, condense, riccati
    return {"riccati.cu": riccati, "condense.cu": condense, "chol.cu": chol}


def reset_launches() -> None:
    for mod in kernel_modules().values():
        for k in mod.KERNELS.values():
            k.launches = 0


def launches() -> dict:
    return {name: k.launches for mod in kernel_modules().values()
            for name, k in mod.KERNELS.items()}


def schedule_of(backend, opts, ticks, cold=1):
    """Kernel launches of ``ticks`` ticks, the first ``cold`` of them cold
    (no warm start; the closed loop's first tick has a zero warm start, so
    it passes ``cold=0``).  Riccati: a cold start adds one factor and one
    apply; each IPM iteration runs one assemble_factor and a K=ns+1 and a
    K=1 apply.  Dense: one condense per tick; a cold (centered) start adds
    one Cholesky factor and solve; each iteration factors once and solves
    twice (predictor, corrector), and ``scale_kkt`` doubles every solve
    (one refinement backsolve); no preset here has correctors or
    polish."""
    assert not (opts.correctors or opts.polish)
    iters = opts.max_iters + opts.refine_restart * opts.refine_iters
    per_solve = 2 if opts.scale_kkt else 1
    exp = {k: 0 for k in launches()}
    if backend == "riccati":
        exp.update(factor=cold, assemble_factor=iters * ticks,
                   apply_bwd=cold + 2 * iters * ticks,
                   apply_fwd=cold + 2 * iters * ticks)
    else:
        exp.update(condense=ticks, chol_factor=cold + iters * ticks,
                   chol_solve=per_solve * (cold + 2 * iters * ticks))
    return exp, iters


def kernel_ms_per_tick(backend, kres, iters, key="", per_solve=1):
    """The hand kernels' share of a warm tick: per-launch times (phase 2;
    ``key`` "_kin": at the kinematic QP's shapes) times launches per warm
    tick."""
    if backend == "riccati":
        return iters * (kres["assemble_factor"]["ms" + key]
                        + kres["apply_bwd"]["ms" + key]
                        + kres["apply_fwd"]["ms" + key]
                        + kres["apply_bwd"]["ms" + key + "_k1"]
                        + kres["apply_fwd"]["ms" + key + "_k1"])
    return kres["condense"]["ms" + key] + iters * (
        kres["chol_factor"]["ms" + key]
        + 2 * per_solve * kres["chol_solve"]["ms" + key])


def build_qp(backend, ltv, model, xc, x_ref, xl, ul):
    """The tick's first layer alone (linearisation, constraint rows,
    condensing for the dense backend, QP assembly)."""
    track, params, mpc = model
    if backend == "riccati":
        return ltv.build_stage_qp_dynamic(xc, x_ref, track, params, mpc, xl,
                                          ul)[0]
    return ltv.build_qp_dynamic(xc, x_ref, track, params, mpc, xl, ul)[0]


def solve_built(backend, qp, opts, warm):
    from fsae_mpc_tpu_torch.ops import ipm, riccati
    if backend == "riccati":
        return riccati.solve_stage_qp(qp, opts, warm=warm)
    return ipm.solve_qp(*qp[:7], opts, warm=warm)


def main_path(backend, model, device, card, kres):
    """One cold solve and WARM_TICKS warm ticks of
    ``ltv_mpc_dynamic(backend=...)`` at B=1024 under each f32 preset, in
    closed loop with the RK4 plant; every launch count is set to 0 just
    before and read just after."""
    import torch
    from fsae_mpc_tpu_torch.mpc import ltv
    from fsae_mpc_tpu_torch.ops import ipm

    track, params, mpc = model
    step = closed_loop_step(track, params, mpc)
    x0_t, x_lin_t, u_lin_t = initial_batch(B_MAIN, mpc, torch.float32,
                                           device)
    schedule = {k: 0 for k in launches()}
    out = {}
    reset_launches()
    for name, opts in (("F32_OPTS", ipm.F32_OPTS),
                       ("F32_PRODUCTION", ipm.F32_PRODUCTION)):
        exp, iters = schedule_of(backend, opts, 1 + WARM_TICKS)
        for k, v in exp.items():
            schedule[k] += v
        before = launches()
        tick = lambda xc, xl, ul, warm=None: ltv.ltv_mpc_dynamic(
            xc, reference(xc, mpc), track, params, mpc, xl, ul, opts,
            warm=warm, backend=backend)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = tick(x0_t, x_lin_t, u_lin_t)
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
            res = tick(xc, xl, ul, warm)
            finite.append(torch.isfinite(res.u_opt).all())
            last = (xc, reference(xc, mpc), xl, ul, res)
            carry = (step(xc, res.u_opt[:, 0]), res.x_opt, res.u_opt, res.qp)
        end.record()
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
        tick_ms = start.elapsed_time(end) / WARM_TICKS
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        check(bool(torch.stack(finite).all()),
              f"{backend} {name}: non-finite u_opt")
        check(bool(torch.isfinite(carry[0]).all()),
              f"{backend} {name}: non-finite closed-loop state")
        got = {k: v - before[k] for k, v in launches().items()}
        log(f"main path {backend} {name}: cold solve {cold_s:.3f} s "
            f"(includes first use), warm tick {tick_ms:.2f} ms (CUDA "
            f"events; host {1e3 * host_s / WARM_TICKS:.2f} ms), "
            f"{B_MAIN / (tick_ms / 1e3):.1f} solves/s at B={B_MAIN}, peak "
            f"device memory {peak_gb:.3f} GB  ({card})")
        log(f"main path {backend} {name}: launches {got}, schedule {exp}")
        check(got == exp, f"{backend} {name}: launches {got} != schedule "
              f"{exp}")
        k_ms = kernel_ms_per_tick(backend, kres, iters)
        log(f"main path {backend} {name}: hand kernels ~{k_ms:.2f} ms of "
            f"the {tick_ms:.2f} ms warm tick ({100 * k_ms / tick_ms:.1f}%; "
            f"per-launch times x launches)")
        out[name] = dict(last=last, tick_ms=tick_ms, peak_gb=peak_gb)
    total = launches()
    check(total == schedule, f"{backend}: launches {total} != schedule "
          f"{schedule}")
    on_path = [k for k, v in schedule.items() if v]
    check(all(total[k] > 0 for k in on_path),
          f"{backend}: a kernel never ran: {total}")
    xc, x_ref, xl, ul, _ = out["F32_OPTS"]["last"]
    build_ms = cuda_ms(lambda: build_qp(backend, ltv, model, xc, x_ref, xl,
                                        ul), 3, warmup=1)
    log(f"main path {backend}: QP build {build_ms:.2f} ms of the warm "
        f"tick at B={B_MAIN}  ({card})")
    return out, {k: total[k] for k in on_path}


def sync_check(backend, out, model):
    """The f32 tick must not synchronise with the host (so that a later
    change can capture it in a CUDA graph): one more warm tick of each
    preset under ``torch.cuda.set_sync_debug_mode("warn")``."""
    import torch
    from fsae_mpc_tpu_torch.mpc import ltv
    from fsae_mpc_tpu_torch.ops import ipm

    counts = {}
    for name, opts in (("F32_OPTS", ipm.F32_OPTS),
                       ("F32_PRODUCTION", ipm.F32_PRODUCTION)):
        xc, x_ref, xl, ul, res = out[name]["last"]
        torch.cuda.synchronize()
        qp, build = sync_debug(lambda: build_qp(backend, ltv, model, xc,
                                                x_ref, xl, ul))
        _, solve = sync_debug(lambda: solve_built(backend, qp, opts,
                                                  res.qp))
        torch.cuda.synchronize()
        counts[name] = (len(build), len(solve))
        log(f"host syncs {backend} {name}: QP build {counts[name][0]}, "
            f"solve {counts[name][1]}  {sorted(set(build + solve))[:8]}")
    check(all(v == (0, 0) for v in counts.values()),
          f"the {backend} f32 tick synchronises with the host: {counts}")


def sync_debug(fn):
    """Run ``fn`` under ``torch.cuda.set_sync_debug_mode("warn")``; returns
    its result and the sites of the host synchronisations it made."""
    import warnings
    import torch
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    # the mode's own notice ("a prototype feature") is not a sync
    return out, [f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}"
                 for w in caught
                 if "called a synchronizing" in str(w.message)]


# ---------------------------------------------------------------------------
# phase 3b: accuracy against a tight f64 solve
# ---------------------------------------------------------------------------


def to_cpu64(t):
    import torch
    return t.detach().to("cpu", torch.float64)


def reference_u(backend, qp, N):
    """A tight f64 solve of the same QP data on CPU tensors (the port's
    plain path, on purpose): the controls (B, N, nu)."""
    import dataclasses
    import torch
    from fsae_mpc_tpu_torch.ops import ipm, riccati

    tight = ipm.IpmOptions(max_iters=60)
    if backend == "riccati":
        qp64 = riccati.StageQP(**{f.name: to_cpu64(getattr(qp, f.name))
                                  for f in dataclasses.fields(qp)})
        u = riccati.solve_stage_qp(qp64, tight).u
    else:
        x = ipm.solve_qp(*[to_cpu64(a) for a in qp[:7]], tight).x
        u = x[:, :N * NU].reshape(-1, N, NU)
    check(bool(torch.isfinite(u).all()), f"{backend}: f64 reference "
          "non-finite")
    return u


def control_errors(tag, u32, ref_u, seconds):
    du = (to_cpu64(u32) - ref_u).abs()
    fc, mean = float(du[:, 0].max()), float(du.mean())
    log(f"accuracy {tag}: first-control max {fc:.3e} (bar "
        f"{ACC_BARS['first_control_max']:.0e}), mean {mean:.3e} (bar "
        f"{ACC_BARS['mean_control']:.0e}); f64 reference {seconds:.1f} s")
    return fc, mean


def accuracy_record_regime(model, device):
    """(a) three ticks of f64 history on CPU tensors, then each preset's
    cold f32 Riccati solve of the fourth tick's QP on the card."""
    import dataclasses
    import torch
    from fsae_mpc_tpu_torch.mpc import ltv
    from fsae_mpc_tpu_torch.ops import ipm, riccati

    track, params, mpc = model
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
    t0 = time.perf_counter()
    ref_u = reference_u("riccati", qp64, mpc.n_steps)
    secs = time.perf_counter() - t0
    for name in ("F32_OPTS", "F32_PRODUCTION"):
        u32 = riccati.solve_stage_qp(qp32, getattr(ipm, name)).u
        check(bool(torch.isfinite(u32).all()), f"{name}: non-finite u")
        fc, mean = control_errors(
            f"riccati {name} (a: {REC_BATCH} instances after {REC_TICKS} "
            "f64 ticks, cold f32 solve)", u32, ref_u, secs)
        if name == "F32_PRODUCTION":
            check(fc <= ACC_BARS["first_control_max"]
                  and mean <= ACC_BARS["mean_control"],
                  f"{name}: accuracy {fc:.3e}/{mean:.3e} outside the bars")


def accuracy_warm_chain(backend, out, model):
    """(b) the last warm tick of the main path, ACC_SUBSET instances."""
    from fsae_mpc_tpu_torch.mpc import ltv

    mpc = model[2]
    refs = {}
    for name, d in out.items():
        xc, x_ref, xl, ul, res = d["last"]
        sub = slice(0, ACC_SUBSET)
        qp = build_qp(backend, ltv, model, xc[sub], x_ref[sub], xl[sub],
                      ul[sub])
        t0 = time.perf_counter()
        ref_u = reference_u(backend, qp, mpc.n_steps)
        fc, mean = control_errors(
            f"{backend} {name} (b: warm tick {WARM_TICKS}, {ACC_SUBSET} "
            "instances)", res.u_opt[sub], ref_u, time.perf_counter() - t0)
        refs[name] = ref_u
        if name in ACC_GUARD:
            g_fc, g_mean = ACC_GUARD[name]
            check(fc <= g_fc and mean <= g_mean,
                  f"{backend} {name}: accuracy {fc:.3e}/{mean:.3e} outside "
                  f"the guard {g_fc:.0e}/{g_mean:.0e}")
    return refs


def accuracy_same_qp(out, dense_refs, model):
    """(c) the dense and Riccati ticks on the same x0 and linearisation
    (the dense path's last F32_PRODUCTION tick) solve the same QP: cold
    f32 solves of both on the card, and tight f64 solves of both."""
    import torch
    from fsae_mpc_tpu_torch.mpc import ltv
    from fsae_mpc_tpu_torch.ops import ipm

    track, params, mpc = model
    xc, x_ref, xl, ul, _ = out["F32_PRODUCTION"]["last"]
    u = {b: ltv.ltv_mpc_dynamic(xc, x_ref, track, params, mpc, xl, ul,
                                ipm.F32_PRODUCTION, backend=b).u_opt
         for b in ("dense", "riccati")}
    du = (u["dense"][:, 0] - u["riccati"][:, 0]).abs()
    log(f"accuracy (c) dense vs riccati, same QP, cold F32_PRODUCTION on "
        f"the card, B={B_MAIN}: first control max {float(du.max()):.3e}, "
        f"mean {float(du.mean()):.3e}")
    sub = slice(0, ACC_SUBSET)
    qp = build_qp("riccati", ltv, model, xc[sub], x_ref[sub], xl[sub],
                  ul[sub])
    ric64 = reference_u("riccati", qp, mpc.n_steps)
    d64 = (dense_refs["F32_PRODUCTION"][:, 0] - ric64[:, 0]).abs()
    log(f"accuracy (c) dense vs riccati, same QP, tight f64 on the CPU, "
        f"{ACC_SUBSET} instances: first control max {float(d64.max()):.3e},"
        f" mean {float(d64.mean()):.3e}")
    check(float(d64.max()) <= ACC_BARS["first_control_max"],
          "dense and Riccati f64 solves of the same QP disagree beyond the "
          "first-control bar")


# ---------------------------------------------------------------------------
# phase 4: the batched closed loop
# ---------------------------------------------------------------------------


def loop_schedule(mode, backend, opts, ticks, sqp_iters):
    """Kernel launches of ``ticks`` closed-loop ticks.  LTV: one warm
    solve a tick (the first tick's warm start is a zero carry, so K4
    never runs).  NMPC: ``sqp_iters`` solves a tick, the first of them
    cold (no warm start crosses ticks: one K4 sweep, or one Cholesky
    factor and solve, a tick) and the others warm-started from their
    predecessor; the trapezoidal transcription condenses with the plain
    ``condense_general``, never K5."""
    if mode == "ltv":
        return schedule_of(backend, opts, ticks, cold=0)
    exp, iters = schedule_of(backend, opts, ticks * sqp_iters, cold=ticks)
    if mode == "c-nmpc":
        exp["condense"] = 0
    return exp, iters


# per NMPC loop (its ``Loop.key``): the phase 2 keys of its Riccati shapes
# and its dense QP's width
NMPC_SHAPES = {"ms-nmpc/dynamic": ("_msdyn", 82),
               "ms-nmpc/kinematic": ("_kin", 81),
               "c-nmpc/dynamic": ("_trdyn", 84),
               "c-nmpc/kinematic": ("_trkin", 83),
               "c-nmpc/kinematic/hs": (None, 163)}


def loop_kernel_ms(loop, kres, opts, iters, sqp_iters):
    """The hand kernels' share of a closed-loop tick: per-launch times
    (phase 2, at the tick's shapes) times launches a tick."""
    mode, name, backend = loop.mode, loop.model, loop.backend
    per_solve = 2 if opts.scale_kkt else 1
    if mode == "ltv":
        return kernel_ms_per_tick(backend, kres, iters,
                                  "_kin" if name == "kinematic" else "",
                                  per_solve)
    rkey, n = NMPC_SHAPES[loop.key]
    if backend == "riccati":
        return (sqp_iters * kernel_ms_per_tick(backend, kres, iters, rkey)
                + kres["factor"]["ms" + rkey])
    dkey = DENSE_KEYS[n]
    chol = (kres["chol_factor"]["ms" + dkey]
            + per_solve * kres["chol_solve"]["ms" + dkey])
    cond = (kres["condense"]["ms" + ("_kin" if name == "kinematic" else "")]
            if mode == "ms-nmpc" else 0.0)
    return sqp_iters * (cond + iters * (
        chol + per_solve * kres["chol_solve"]["ms" + dkey])) + chol


def cpu_reference_laps(loop, ticks, plan=None):
    """The laps of instances 0..SIM_CHECK-1 of ``sim_scenarios`` by the
    port on the CPU in f32 (the plain versions), one thread: the plant
    states (SIM_CHECK, ticks, 7) as numpy.  ``plan``: the raceline plan's
    fields as numpy (f64), for ``reference="raceline"``.  Run in a worker
    process (see :func:`closed_loop_phase`)."""
    import torch
    sys.path.insert(0, ROOT)
    from fsae_mpc_tpu_torch import interop
    from fsae_mpc_tpu_torch.config import MPC_F32, VehicleParams
    from fsae_mpc_tpu_torch.sim import simulate
    from fsae_mpc_tpu_torch.track import load_track

    torch.set_num_threads(1)
    track, _ = load_track(os.path.join(ROOT, "data", "fsg2019.csv"),
                          dtype=torch.float32, device="cpu")
    t0 = time.perf_counter()
    out = simulate(track, VehicleParams(), loop.sim_config(ticks, MPC_F32),
                   torch.tensor(sim_scenarios(B_SIM)[:SIM_CHECK],
                                dtype=torch.float32),
                   plan=None if plan is None else interop.planner_result(
                       plan, device="cpu"))
    return out.x_history.numpy(), time.perf_counter() - t0


def start_cpu_references(pool, configs, ticks, plan=None):
    """Start :func:`cpu_reference_laps` of each config on ``pool`` (a
    ``multiprocessing`` pool): the CPU's f32 laps run beside the card's
    phases."""
    return {c: pool.apply_async(cpu_reference_laps, (c, ticks, plan))
            for c in configs}


def closed_loop_phase(label, configs, ticks, tols, model, device, card,
                      kres, cpu_refs=None, plan=None):
    """``sim.simulate`` at B_SIM laps for ``ticks`` ticks in each
    :class:`Loop` of ``configs``: launch counts equal to the schedule
    (:func:`loop_schedule`), no host synchronisation, every trace finite,
    instances 0..SIM_CHECK-1 against the port's own f32 run of the same
    laps on the CPU within ``tols`` (keyed by ``Loop.key``): ``cpu_refs``
    maps a config to the pending result of those laps from
    :func:`start_cpu_references`, else they run here.  ``plan``: the plan
    a raceline loop tracks.  Returns the launch counts of each run."""
    import torch
    from fsae_mpc_tpu_torch import interop
    from fsae_mpc_tpu_torch.sim import simulate
    from fsae_mpc_tpu_torch.sim.closed_loop import CONV_THRESHOLDS

    track, params, mpc = model
    x_init = sim_scenarios(B_SIM)
    x_t = torch.tensor(x_init, dtype=torch.float32, device=device)
    track_cpu = track.to("cpu")
    counts = []
    for loop in configs:
        mode, name, backend = loop.mode, loop.model, loop.backend
        tag = loop.tag
        cfg = loop.sim_config(ticks, mpc)
        opts = cfg.ipm
        exp, iters = loop_schedule(mode, backend, opts, ticks,
                                   cfg.sqp_iters)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()

        def run():
            start.record()
            out = simulate(track, params, cfg, x_t, plan=plan)
            end.record()
            return out

        t0 = time.perf_counter()
        out, syncs = sync_debug(run)
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
        got = launches()
        tick_ms = start.elapsed_time(end) / ticks
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        log(f"{label} {tag}: {tick_ms:.2f} ms a sim tick at B={B_SIM} (CUDA "
            f"events over {ticks} ticks, the first included; host "
            f"{1e3 * host_s / ticks:.2f} ms), "
            f"{B_SIM * 1e3 / tick_ms:.1f} instance-ticks/s, peak device "
            f"memory {peak_gb:.3f} GB  ({card})")
        log(f"{label} {tag}: launches {got}, schedule {exp} (per tick "
            f"{ {k: v // ticks for k, v in exp.items() if v} })")
        check(got == exp, f"{label} {tag}: launches {got} != schedule {exp}")
        k4 = 0 if mode == "ltv" or backend == "dense" else ticks
        check(got["factor"] == k4, f"{label} {tag}: K4 launched "
              f"{got['factor']} times, not {k4}")
        log(f"{label} {tag}: host syncs inside simulate {len(syncs)} "
            f"{sorted(set(syncs))[:8]}")
        check(not syncs, f"{label} {tag}: simulate synchronises with the "
              "host")
        k_ms = loop_kernel_ms(loop, kres, opts, iters, cfg.sqp_iters)
        log(f"{label} {tag}: hand kernels ~{k_ms:.2f} ms of the "
            f"{tick_ms:.2f} ms sim tick ({100 * k_ms / tick_ms:.1f}%; "
            "per-launch times x launches)")
        traces = {f: getattr(out, f) for f in (
            "x_history", "u_history", "n_history", "obj_history", "slack_n",
            "slack_tyre", "qp_pres", "qp_mu", "fcr")}
        bad = [f for f, t in traces.items() if not bool(
            torch.isfinite(t).all())]
        check(not bad, f"{label} {tag}: non-finite traces {bad}")
        act = out.active.float()
        log(f"{label} {tag}: lap done {int(out.lap_done.sum())} of {B_SIM}, "
            f"mean |n| {float(out.n_history.abs().mean()):.4f} m, plant "
            f"speed at the end {float(out.x_history[:, -1, 3].mean()):.3f}"
            f" m/s, abnormal exits {float(out.abnormal_exit_frac.mean()):.3f}"
            f" (bar {CONV_THRESHOLDS[backend]}), active share "
            f"{float(act.mean()):.3f}")
        sim_breakdown(f"{label} {tag}", cfg, model, out.x_history[:, -1],
                      tick_ms, card, plan)
        # the same laps on the CPU in f32, through the plain versions
        if cpu_refs is not None:
            t0 = time.perf_counter()
            ref_x, cpu_s = cpu_refs[loop].get()
            ref_x = torch.from_numpy(ref_x)
            wait = f"; waited {time.perf_counter() - t0:.1f} s for it"
        else:
            t0 = time.perf_counter()
            ref_x = simulate(track_cpu, params, cfg, torch.tensor(
                x_init[:SIM_CHECK], dtype=torch.float32),
                plan=None if plan is None else interop.planner_result(
                    interop.to_numpy(plan), device="cpu")).x_history
            cpu_s, wait = time.perf_counter() - t0, ""
        d = (out.x_history[:SIM_CHECK].cpu().double()
             - ref_x.double()).abs().amax((0, 1))
        tol = tols[loop.key]
        log(f"{label} {tag}: instances 0-{SIM_CHECK - 1} card vs CPU f32, "
            f"max |dx| per state {[f'{v:.2e}' for v in d.tolist()]}, tol "
            f"{[f'{v:.2e}' for v in tol]} (CPU run {cpu_s:.1f} s{wait})")
        check(all(a <= b for a, b in zip(d.tolist(), tol)),
              f"{label} {tag}: card and CPU laps differ beyond the "
              "tolerance")
        counts.append({k: v for k, v in got.items() if v})
    return counts


def sim_breakdown(tag, cfg, model, x, tick_ms, card, plan=None):
    """Where a sim tick's time goes: each of its parts timed alone at the
    batch's last plant states (CUDA events, 3 calls after one more): the
    projection, the reference, the MPC tick (from the first tick's guess;
    LTV with the zero warm start) and the 10 PID+RK6 plant substeps; the
    rest (freezing, tyre force, convergence flags) is the difference."""
    import torch
    from fsae_mpc_tpu_torch.models import transforms
    from fsae_mpc_tpu_torch.sim import closed_loop as cl

    track, params, mpc = model
    Bsz = x.shape[0]
    x_opt, u_opt = cl._initial_guess(cfg, Bsz, x.dtype, x.device)
    warm = (cl._zero_warm(cfg, Bsz, x.dtype, x.device) if cfg.mode == "ltv"
            else None)
    s, n, mu = transforms.cartesian_to_curvilinear(
        x[:, 0], x[:, 1], x[:, 2], track, x_opt[:, 0, 0])
    if cfg.model == "kinematic":
        x0 = torch.stack([s, n, mu, torch.hypot(x[:, 3], x[:, 4]), x[:, 6]],
                         -1)
    else:
        x0 = torch.stack([s, n, mu, x[:, 3], x[:, 4], x[:, 5], x[:, 6]], -1)
    if cfg.reference == "raceline":
        reference = lambda: cl._raceline_reference(plan, track, cfg, x0)
    else:
        reference = lambda: cl._reference(cfg, x0, x[:, 3])
    x_ref = reference()
    solver = cl._solver(track, params, cfg)
    pids = (torch.zeros_like(x[:, 0]), torch.zeros_like(x[:, 0]))
    parts = {
        "projection": lambda: transforms.cartesian_to_curvilinear(
            x[:, 0], x[:, 1], x[:, 2], track, x_opt[:, 0, 0]),
        "reference": reference,
        "MPC tick": lambda: solver(x0, x_ref, x_opt, u_opt, warm),
        "plant substeps": lambda: cl.plant_substeps(
            x, x[:, 3] + 1.0, x[:, 6], (pids, pids), params, mpc.dt,
            cfg.n_substeps),
    }
    ms = {k: cuda_ms(fn, 3, warmup=1) for k, fn in parts.items()}
    rest = tick_ms - sum(ms.values())
    log(f"{tag}: sim tick {tick_ms:.2f} ms = " + ", ".join(
        f"{k} {v:.2f}" for k, v in ms.items()) + f", rest {rest:.2f} ms "
        f"(each part alone, CUDA events)  ({card})")


# ---------------------------------------------------------------------------
# phase 5: one timed lap
# ---------------------------------------------------------------------------


def lap_phase(model, card):
    """``sim.simulate_timed`` at B=1 until the lap is done: lap done, its
    time within LAP_TIME_TOL of the f64 lap, bounded track violation,
    launches equal to the schedule (the discarded first tick included),
    and the tick times against the 50 ms budget.  Returns the launch
    counts."""
    from fsae_mpc_tpu_torch.ops import ipm
    from fsae_mpc_tpu_torch.sim import SimConfig, simulate_timed
    from fsae_mpc_tpu_torch.sim.closed_loop import CONV_THRESHOLDS

    track, params, mpc = model
    cfg = SimConfig(model="dynamic", qp_backend="dense", n_ticks=LAP_TICKS,
                    mpc=mpc, ipm=ipm.F32_ACCURATE)
    reset_launches()
    t0 = time.perf_counter()
    out, timing = simulate_timed(track, params, cfg)
    wall = time.perf_counter() - t0
    got = launches()
    n = timing["n_ticks_timed"]
    exp, _ = schedule_of("dense", cfg.ipm, n + 1, cold=0)
    lap_time = float(out.lap_time[0])
    viol = float(out.track_violation[0])
    log(f"lap dynamic/dense/F32_ACCURATE B=1: {n} ticks timed ({wall:.1f} s"
        f" wall), tick mean {1e3 * timing['tick_time_mean_s']:.2f} ms, "
        f"median {1e3 * timing['tick_time_median_s']:.2f}, p99 "
        f"{1e3 * timing['tick_time_p99_s']:.2f}, max "
        f"{1e3 * timing['tick_time_max_s']:.2f} against the "
        f"{1e3 * timing['budget_s']:.0f} ms budget (host clock)  ({card})")
    log(f"lap: done {bool(out.lap_done[0])}, lap time {lap_time:.2f} s "
        f"(f64 {LAP_T64:.2f} s, tol {LAP_TIME_TOL}), track violation "
        f"{viol:.4f} (bound {LAP_TRACK_VIOLATION}), max "
        f"{float(out.max_track_violation[0]):.4f}, tyre violation "
        f"{float(out.tyre_violation[0]):.4f}, abnormal exits "
        f"{float(out.abnormal_exit_frac[0]):.3f} (bar "
        f"{CONV_THRESHOLDS['dense']})")
    log(f"lap: launches {got}, schedule {exp}")
    check(bool(out.lap_done[0]), "lap: not done")
    check(abs(lap_time - LAP_T64) <= LAP_TIME_TOL,
          f"lap: time {lap_time:.2f} s, f64 {LAP_T64:.2f} s")
    check(viol < LAP_TRACK_VIOLATION, f"lap: track violation {viol:.4f}")
    check(got == exp, f"lap: launches {got} != schedule {exp}")
    return {k: v for k, v in got.items() if v}


# ---------------------------------------------------------------------------
# phase 7: the minimum-time planner and the raceline loop
# ---------------------------------------------------------------------------


def planner_phase(device, card):
    """``minimum_time_planner_dynamic`` on fsg2019 in f64 on the card
    (``chol="lapack"``) at PLAN_REF_NODES and PLAN_NODES nodes: no kernel
    launched, every output finite, the first plan's lap time within
    PLAN_TIME_TOL of the JAX package's f64 plan and its defect at most
    PLAN_DEFECT_MAX.  Returns the second plan
    (on the card, f64) and its fields as numpy (to ``PLAN_OUT`` when that
    environment variable names a file)."""
    import numpy as np
    import torch
    from fsae_mpc_tpu_torch import interop
    from fsae_mpc_tpu_torch.config import VehicleParams
    from fsae_mpc_tpu_torch.ops import ipm
    from fsae_mpc_tpu_torch.planner import minimum_time_planner_dynamic
    from fsae_mpc_tpu_torch.track import load_track

    track64, _ = load_track(os.path.join(ROOT, "data", "fsg2019.csv"),
                            dtype=torch.float64, device=device)
    for nodes in (PLAN_REF_NODES, PLAN_NODES):
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plan = minimum_time_planner_dynamic(
            track64, VehicleParams(), n_nodes=nodes, iters=PLAN_ITERS,
            opts=ipm.IpmOptions(chol="lapack"))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = launches()
        fields = interop.to_numpy(plan)
        lap = float(fields["lap_time"])
        held = (f" (JAX f64 on a CPU {PLAN_T64} s, tol {PLAN_TIME_TOL:.4f};"
                f" defect bound {PLAN_DEFECT_MAX:.4f})"
                if nodes == PLAN_REF_NODES else "")
        log(f"plan dynamic f64 on the card, {nodes} nodes, {PLAN_ITERS} SQP "
            f"iterations: {wall:.1f} s wall (host clock, synchronised), lap "
            f"time {lap:.4f} s{held}, defect "
            f"{float(fields['defect_norm']):.3e}, slacks "
            f"{fields['slack'].tolist()}, merit {float(fields['merit']):.4f}"
            f", mean x_d {float(fields['y_opt'][:, 2].mean()):.3f} m/s, |n| "
            f"max {float(np.abs(fields['y_opt'][:, 0]).max()):.3f} m; "
            f"launches {sum(got.values())}  ({card})")
        check(not any(got.values()), f"plan {nodes}: kernels launched {got}")
        check(all(bool(np.isfinite(v).all()) for v in fields.values()),
              f"plan {nodes}: non-finite outputs")
        if nodes == PLAN_REF_NODES:
            check(abs(lap - PLAN_T64) <= PLAN_TIME_TOL,
                  f"plan: lap time {lap:.4f} s, JAX f64 {PLAN_T64} s")
            check(float(fields["defect_norm"]) <= PLAN_DEFECT_MAX,
                  f"plan: defect {float(fields['defect_norm']):.3e} > "
                  f"{PLAN_DEFECT_MAX:.3e}")
    if os.environ.get("PLAN_OUT"):
        np.savez(os.environ["PLAN_OUT"], **fields)
    return plan, fields


# ---------------------------------------------------------------------------
# phase 8: the pod-scale sweep
# ---------------------------------------------------------------------------


def pod_batch(device):
    """The sweep's batch on the card: the stacked tracks, each repeated
    for POD_VEHICLES instances (track-major, as ``pod_scale.py``), and one
    perturbed vehicle per instance."""
    import torch
    from fsae_mpc_tpu_torch.config import VehicleParams
    from fsae_mpc_tpu_torch.sim.batch import perturbed_params
    from fsae_mpc_tpu_torch.track import load_track, stack_tracks
    from fsae_mpc_tpu_torch.utils import tree

    tracks = stack_tracks([load_track(
        os.path.join(ROOT, "data", f"{name}.csv"), dtype=torch.float32,
        device=device) for name in POD_TRACKS])
    track = tree.map(lambda t: t.repeat_interleave(POD_VEHICLES, 0), tracks)
    params = perturbed_params(
        VehicleParams(), torch.Generator(device).manual_seed(SEED),
        len(POD_TRACKS) * POD_VEHICLES, device=device)
    return track, params


def pod_instances(fields, dtype):
    """The checked instances (POD_CHECK) on the CPU: each one's track
    stacked, and its vehicle from ``fields`` (numpy (len(POD_CHECK),) per
    ``VehicleParams`` field, the card's draws)."""
    from fsae_mpc_tpu_torch import interop
    from fsae_mpc_tpu_torch.track import load_track, stack_tracks
    return (stack_tracks([load_track(
        os.path.join(ROOT, "data", f"{POD_TRACKS[i // POD_VEHICLES]}.csv"),
        dtype=dtype, device="cpu") for i in POD_CHECK]),
        interop.vehicle_params(fields, dtype=dtype, device="cpu"))


def pod_reference_laps(fields):
    """The checked instances' laps by the port on the CPU in f32, one
    thread: the plant states (len(POD_CHECK), POD_TICKS, 7) as numpy.  Run
    in a worker process."""
    import torch
    sys.path.insert(0, ROOT)
    from fsae_mpc_tpu_torch.config import MPC_F32
    from fsae_mpc_tpu_torch.sim import simulate

    torch.set_num_threads(1)
    track, params = pod_instances(fields, torch.float32)
    t0 = time.perf_counter()
    out = simulate(track, params, POD_CONFIG.sim_config(POD_TICKS, MPC_F32),
                   torch.zeros((len(POD_CHECK), 7), dtype=torch.float32))
    return out.x_history.numpy(), time.perf_counter() - t0


def pod_fields(params):
    """The checked instances' vehicles as numpy, for the CPU's laps (and
    as JSON to the file ``POD_OUT`` names, for the divergence tool)."""
    import dataclasses
    idx = list(POD_CHECK)
    fields = {f.name: getattr(params, f.name)[idx].cpu().numpy()
              for f in dataclasses.fields(params)}
    if os.environ.get("POD_OUT"):
        with open(os.environ["POD_OUT"], "w") as f:
            json.dump({k: v.tolist() for k, v in fields.items()}, f)
    return fields


def pod_phase(device, card, track, params, cpu_ref):
    """The sweep through ``checkpoint.run_chunked``, its resume and
    ``simulate`` of the same ticks, the checked instances against the
    CPU's laps (``cpu_ref``: the pending :func:`pod_reference_laps`),
    the shard check and the reduced summary.  Returns the chunked run's
    launch counts."""
    import dataclasses
    import tempfile
    import torch
    from fsae_mpc_tpu_torch.config import MPC_F32
    from fsae_mpc_tpu_torch.models import transforms
    from fsae_mpc_tpu_torch.mpc import ltv
    from fsae_mpc_tpu_torch.ops import riccati
    from fsae_mpc_tpu_torch.parallel import mesh as pm
    from fsae_mpc_tpu_torch.sim import checkpoint, simulate
    from fsae_mpc_tpu_torch.sim import closed_loop as cl
    from fsae_mpc_tpu_torch.utils import debug, profiling

    Bsz = track.px.shape[0]
    tag = f"pod {len(POD_TRACKS)} x {POD_VEHICLES} {POD_CONFIG.tag}"
    cfg = POD_CONFIG.sim_config(POD_TICKS, MPC_F32)
    exp, iters = loop_schedule("ltv", "riccati", cfg.ipm, POD_TICKS, 1)
    x0 = torch.zeros((Bsz, 7), dtype=torch.float32, device=device)
    n_chunks = -(-POD_TICKS // POD_CHUNK)
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    carry0 = cl.init_chunked(track, params, cfg, x0)
    step = profiling.Timed(cl.chunk_step(track, params, cfg, POD_CHUNK))
    syncs = []

    def chunk(carry):
        out, sites = sync_debug(lambda: step(carry))
        syncs.append(sites)
        return out

    with tempfile.TemporaryDirectory() as ckpt:
        reset_launches()
        t0 = time.perf_counter()
        carry = checkpoint.run_chunked(chunk, carry0, n_chunks, ckpt)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = launches()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        out = cl.chunked_outputs(carry, cfg, params)
        ckpt_mb = os.path.getsize(checkpoint.chunk_path(ckpt, 0)) / 1e6
        restored = checkpoint.restore(checkpoint.chunk_path(ckpt, 0), carry0)
        resumed = cl.simulate_chunked(track, params, cfg, POD_CHUNK,
                                      carry=restored, start_tick=POD_CHUNK)
    chunk_s = profiling.stats(step.samples)
    tick_ms = 1e3 * chunk_s["mean"] / POD_CHUNK
    log(f"{tag}: B={Bsz}, {POD_TICKS} ticks in {n_chunks} chunks of "
        f"{POD_CHUNK}: {tick_ms:.2f} ms a sim tick (CUDA events over each "
        f"chunk; per chunk mean {1e3 * chunk_s['mean']:.1f}, median "
        f"{1e3 * chunk_s['median']:.1f}, max {1e3 * chunk_s['max']:.1f} ms"
        f"), {Bsz * 1e3 / tick_ms:.1f} instance-ticks/s, peak device "
        f"memory {peak_gb:.3f} GB, wall {wall:.1f} s with the checkpoints "
        f"({ckpt_mb:.1f} MB each)  ({card})")
    log(f"{tag}: launches {got}, schedule {exp} (per tick "
        f"{ {k: v // POD_TICKS for k, v in exp.items() if v} })")
    check(got == exp, f"{tag}: launches {got} != schedule {exp}")
    log(f"{tag}: host syncs inside each chunk {[len(s) for s in syncs]} "
        f"{sorted({x for s in syncs for x in s})[:8]}")
    check(not any(syncs), f"{tag}: a chunk synchronises with the host")
    fields = [f.name for f in dataclasses.fields(out)]
    summaries = fields[fields.index("lap_time"):]
    bad_inst = ~torch.isfinite(out.x_history).all(2).all(1)
    log(f"{tag}: instances with a non-finite plant trace "
        f"{int(bad_inst.sum())} of {Bsz}; lap done "
        f"{int(out.lap_done.sum())}, plant speed at the end "
        f"{float(out.x_history[:, -1, 3].mean()):.3f} m/s, abnormal exits "
        f"{float(out.abnormal_exit_frac.mean()):.3f}")
    try:
        debug.assert_finite({f: getattr(out, f) for f in fields},
                            f"{tag} outputs")
    except FloatingPointError as e:
        raise Fail(str(e)) from None

    # the resumed run and simulate of the same ticks, field by field
    whole, sim_syncs = sync_debug(lambda: simulate(track, params, cfg, x0))
    check(not sim_syncs, f"{tag}: simulate synchronises with the host")
    for name, other in (("resumed from chunk 0", resumed),
                        ("simulate", whole)):
        diff = {f: float((getattr(other, f).double()
                          - getattr(out, f).double()).abs().max())
                for f in fields}
        same = all(torch.equal(getattr(other, f), getattr(out, f))
                   for f in fields)
        log(f"{tag}: {name} against the chunked run: "
            f"{'bitwise equal' if same else 'differs'}, max |d| "
            f"{max(diff.values()):.3e} ({max(diff, key=diff.get)})")
        check(same, f"{tag}: {name} differs from the chunked run: {diff}")

    # the checked instances against the CPU's f32 laps
    t0 = time.perf_counter()
    ref_x, cpu_s = cpu_ref.get()
    wait = time.perf_counter() - t0
    d = (out.x_history[list(POD_CHECK)].cpu().double()
         - torch.from_numpy(ref_x).double()).abs().amax((0, 1))
    log(f"{tag}: instances {list(POD_CHECK)} card vs CPU f32, max |dx| per "
        f"state {[f'{v:.2e}' for v in d.tolist()]}, tol "
        f"{[f'{v:.2e}' for v in POD_STATE_TOL]} (CPU run {cpu_s:.1f} s; "
        f"waited {wait:.1f} s for it)")
    check(all(a <= b for a, b in zip(d.tolist(), POD_STATE_TOL)),
          f"{tag}: card and CPU laps differ beyond the tolerance")

    # one shard per track, on the one card: a cold Riccati LTV tick
    # (ltv_mpc_dynamic's build and solve) of phase 3's states
    mesh = pm.make_mesh(devices=[device] * len(POD_TRACKS))
    xc, xl, ul = initial_batch(Bsz, MPC_F32, torch.float32, device)

    def tick(a, r, xlin, ulin, tr, pr):
        qp = ltv.build_stage_qp_dynamic(a, r, tr, pr, MPC_F32, xlin, ulin)[0]
        return {"qp": qp, "u": riccati.solve_stage_qp(qp, cfg.ipm).u}

    args = (xc, reference(xc, MPC_F32), xl, ul, track, params)
    dev = debug.check_shard_determinism(tick, args, mesh)
    qp_dev = max(float(getattr(dev["qp"], f.name).max())
                 for f in dataclasses.fields(dev["qp"]))
    u0 = tick(*args)["u"]
    ulp = []
    for toward in (float("inf"), -float("inf")):
        xp = xc.clone()
        xp[:, 0] = torch.nextafter(xp[:, 0], torch.full_like(xp[:, 0],
                                                             toward))
        ulp.append((tick(xp, *args[1:])["u"] - u0).abs().amax((1, 2)))
    ulp = torch.maximum(*ulp).double()
    qs = torch.tensor(POD_QUANTILES, dtype=torch.float64, device=device)
    q_sh, q_ulp = torch.quantile(dev["u"], qs), torch.quantile(ulp, qs)
    log(f"{tag}: one cold Riccati LTV tick of the batch against "
        f"{len(mesh)} shards on {device}: stage QPs max |d| {qp_dev:.3e}; "
        f"first controls per instance |du| at quantiles {POD_QUANTILES} "
        f"{[f'{v:.2e}' for v in q_sh.tolist()]}, max "
        f"{float(dev['u'].max()):.3e}, bitwise "
        f"{int((dev['u'] == 0).sum())} of {Bsz}; s0 one f32 unit up or "
        f"down {[f'{v:.2e}' for v in q_ulp.tolist()]}, max "
        f"{float(ulp.max()):.3e}")
    check(qp_dev == 0.0, f"{tag}: the shards' QPs differ from the batch's")
    check(bool((q_sh <= q_ulp).all()), f"{tag}: the shards' controls part "
          "further than a last-digit change of the inputs moves them")

    # the metric summary, reduced over the mesh
    xe = out.x_history[:, -1]
    s_end, _, _ = transforms.cartesian_to_curvilinear(
        xe[:, 0], xe[:, 1], xe[:, 2], track, carry.state[1][:, 0, 0])
    summary = pm.pmean_metrics({
        "lap_progress": s_end / track.L,
        "track_violation": out.track_violation,
        "converged_share": out.converged.float().mean(1),
        "lap_done": out.lap_done}, mesh)
    log(f"{tag}: mean over the mesh " + json.dumps(
        {k: float(v) for k, v in summary.items()}) + f"  ({card})")
    return {k: v for k, v in got.items() if v}


def kernel_line(kres, paths):
    """The ``kernels`` JSON object: every kernel with its launches on the
    paths' runs (phases 3-8, summed), its parity and its times (at the
    main path's shapes) beside its bound."""
    out = []
    for source, mod in kernel_modules().items():
        for name, k in mod.KERNELS.items():
            r = kres[name]
            out.append({
                "name": name, "route": "cuda",
                "source": f"fsae_mpc_tpu_torch/csrc/{source}",
                "replaces": k.replaces,
                "launches": sum(p.get(name, 0) for p in paths),
                "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    return {"kernels": out}


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
    from fsae_mpc_tpu_torch.config import MPC_F32, VehicleParams
    from fsae_mpc_tpu_torch.ops.kernels import build as kbuild
    from fsae_mpc_tpu_torch.ops.kernels import chol as kc
    from fsae_mpc_tpu_torch.ops.kernels import riccati as kr
    from fsae_mpc_tpu_torch.track import load_track

    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    cpu_pool = None
    try:
        t0 = time.perf_counter()
        plant_defs = {n: (f"RICCATI_PLANT={n}",) for n in PLANTS}
        chol_defs = {n: (f"CHOL_PLANT={n}",) for n in CHOL_PLANTS}
        libs = kbuild.build(*kbuild.SOURCES, *(
            ("riccati.cu", d) for d in plant_defs.values()), *(
            ("chol.cu", d) for d in chol_defs.values()))
        log(f"build: {[os.path.relpath(lib, ROOT) for lib in libs]} in "
            f"{time.perf_counter() - t0:.1f} s (one nvcc per library, "
            "in parallel)")
        plants = {n: kbuild.Library("riccati.cu", kr._LIB.signatures, d)
                  for n, d in plant_defs.items()}
        chol_plants = {n: kbuild.Library("chol.cu", kc._LIB.signatures, d)
                       for n, d in chol_defs.items()}
        for lib in libs[:len(kbuild.SOURCES)]:
            with open(lib[:-3] + ".log") as f:
                for line in f:
                    if ("registers" in line or "spill" in line
                            or "Compiling entry" in line):
                        log("ptxas: " + line.strip())
        kres = kernel_phase(kr, device, card, plants)
        kres.update(dense_kernel_phase(device, card, chol_plants))
        track, _ = load_track(os.path.join(ROOT, "data", "fsg2019.csv"),
                              dtype=torch.float32, device=device)
        model = (track, VehicleParams(), MPC_F32)
        entry_phase(model, device)
        # phase 7's plan first: the CPU's laps on it then run beside
        # phases 3-6
        plan, plan_np = planner_phase(device, card)
        pod_track, pod_params = pod_batch(device)
        # phase 6's, 7's and 8's CPU laps (minutes on one core each) run
        # in worker processes beside phases 3-5 on the card
        cpu_pool = multiprocessing.get_context("spawn").Pool(
            len(NMPC_CONFIGS) + 2)
        nmpc_refs = start_cpu_references(cpu_pool, NMPC_CONFIGS, NMPC_TICKS)
        raceline_refs = start_cpu_references(
            cpu_pool, [RACELINE_CONFIG], RACELINE_TICKS, plan_np)
        pod_ref = cpu_pool.apply_async(pod_reference_laps,
                                       (pod_fields(pod_params),))
        paths, outs = [], {}
        for backend in ("riccati", "dense"):
            outs[backend], counts = main_path(backend, model, device, card,
                                              kres)
            paths.append(counts)
            sync_check(backend, outs[backend], model)
        accuracy_record_regime(model, device)
        accuracy_warm_chain("riccati", outs["riccati"], model)
        dense_refs = accuracy_warm_chain("dense", outs["dense"], model)
        accuracy_same_qp(outs["dense"], dense_refs, model)
        paths.extend(closed_loop_phase(
            "sim", SIM_CONFIGS, SIM_TICKS, SIM_STATE_TOL, model, device,
            card, kres))
        paths.append(lap_phase(model, card))
        paths.extend(closed_loop_phase(
            "nmpc", NMPC_CONFIGS, NMPC_TICKS, NMPC_STATE_TOL, model, device,
            card, kres, nmpc_refs))
        paths.extend(closed_loop_phase(
            "raceline", [RACELINE_CONFIG], RACELINE_TICKS,
            RACELINE_STATE_TOL, model, device, card, kres, raceline_refs,
            plan=plan))
        paths.append(pod_phase(device, card, pod_track, pod_params, pod_ref))
        line = kernel_line(kres, paths)
    except Fail as e:
        log(f"FAIL: {e}")
        return 1
    finally:
        if cpu_pool is not None:        # every worker stops here
            cpu_pool.terminate()
            cpu_pool.join()

    print(card_line(), flush=True)
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
