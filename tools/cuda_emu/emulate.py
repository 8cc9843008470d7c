#!/usr/bin/env python3
"""Run the kernels of ``fsae_mpc_tpu_torch/csrc/riccati.cu`` and
``csrc/chol.cu`` on the CPU and hold them against their plain PyTorch
versions.

    python3 tools/cuda_emu/emulate.py [--source riccati|chol|all]
                                      [--batch B] [--stages N] [--rows R]
                                      [--n N [N ...]] [--plant N]
                                      [--chol-plant N] [--defer] [--tsan]

For a machine without a card: ``g++`` (C++20) compiles a source against
the stand-in runtime beside this file (``cuda_runtime.h``) into
``fsae_mpc_tpu_torch/build/cuda_emu/``, and runs its kernels on CPU
tensors.

riccati.cu: every case that ``chip_smoke.kernel_phase`` checks at its odd
batch (nx 5/7/9, ns 1/2/4, K = ns+1 and K = 1, N=40, r=20) runs through the
four entry points; ``--stages`` and ``--rows`` change N and r (``--rows
300`` splits each stage's rows over several chunks).  Each output is held
against the plain version normwise and per instance and output block
(tolerance ``chip_smoke.KERNEL_RTOL``).  For each of K1-K4 the script
prints each launch's grid, block and dynamic shared memory, and how many
such blocks the H100's shared memory holds per SM.

chol.cu: the factor (K6) at each n of ``--n`` (default: the LTV and NMPC
widths 84, 81, 82, 83; ``--n 163 192``: the Hermite-Simpson width and the
widest, above 48 KB of shared memory, which the stand-in runtime refuses
without the kernel's opt-in, as the card does), then the solve (K7) on
the plain factor and on K6's (with each launch's grid, block and shared
memory), held by componentwise backward error
(``chip_smoke.chol_backward``) and normwise; and the NaN-poison case at
the first n (``chip_smoke.chol_poisoned``: NaN from the first failing
pivot on).

  --plant N       build riccati.cu with ``-DRICCATI_PLANT=N`` (runs
                  riccati.cu only): the fault's kernel must then fail its
                  check (exit 0 if it does)
  --chol-plant N  build chol.cu with ``-DCHOL_PLANT=N`` (runs chol.cu
                  only): faults 1, 5 (K6), 3, 4 and 6 (K7) must fail the
                  backward-error check, fault 2 the NaN-poison check
                  (5 and 6 exist only above n = 160: ``--n 163``)
  --defer         cp.async copies land at the wait that covers them, not
                  at issue (a read before its wait then sees NaN)
  --tsan          build with ThreadSanitizer and run under it: a missing
                  barrier shows as a data race on the emulated shared
                  memory

It checks indexing, staging and barriers; the card's speed and its FMA
contraction are for ``chip_smoke.py``.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
CSRC = os.path.join(ROOT, "fsae_mpc_tpu_torch", "csrc")
OUT = os.path.join(ROOT, "fsae_mpc_tpu_torch", "build", "cuda_emu")
# source -> its planted-fault macro
MACROS = {"riccati": "RICCATI_PLANT", "chol": "CHOL_PLANT"}
# H100: shared memory of one SM, and what the runtime reserves per block
SM_SHARED, BLOCK_RESERVED = 233472, 1024


def translate(src: str) -> str:
    """The CUDA source as C++ for the stand-in runtime: shared memory is
    its static array, ``k<<<grid, block, smem, stream>>>(args)`` a call of
    ``emu_launch``."""
    src = re.sub(r"extern __shared__ (?:__align__\(16\) )?float (\w+)\[\];",
                 r"float* \1 = emu_smem;", src)
    src = re.sub(r"([\w:]+(?:<[\w, ]+>)?)[\s\\]*<<<(.*?)>>>\(",
                 lambda m: f"emu_launch({m.group(1)}, {m.group(2)}, ", src,
                 flags=re.S)
    return ('#include "cuda_runtime.h"\n' + src
            + '\nextern "C" void emu_last_launch(long* o) '
              '{ for (int i = 0; i < 5; ++i) o[i] = emu_last[i]; }\n')


def compile_lib(source: str, plant: int, tsan: bool) -> str:
    os.makedirs(OUT, exist_ok=True)
    tag = f"{source}_p{plant}" + ("_tsan" if tsan else "")
    cpp = os.path.join(OUT, f"{tag}.cpp")
    lib = os.path.join(OUT, f"lib{tag}.so")
    with open(os.path.join(CSRC, source + ".cu")) as f, open(cpp, "w") as g:
        g.write(translate(f.read()))
    cmd = ["g++", "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
           f"-I{HERE}", f"-D{MACROS[source]}={plant}", "-o", lib, cpp]
    if tsan:
        cmd.insert(1, "-fsanitize=thread")
    subprocess.run(cmd, check=True)
    return lib


def load(lib_path: str, signatures: dict):
    """The library with its entry points typed, and ``call(sym, *args)``:
    runs one entry point and returns (grid x, grid y, block, shared
    bytes, launches) of its launch."""
    import torch
    lib = ctypes.CDLL(lib_path)
    for sym, argtypes in signatures.items():
        fn = getattr(lib, sym)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.emu_last_launch.argtypes = [ctypes.POINTER(ctypes.c_long)]

    def call(sym, *args):
        conv = [a.data_ptr() if isinstance(a, torch.Tensor) else a
                for a in args]
        err = getattr(lib, sym)(*conv, None)
        if err:
            raise RuntimeError(f"{sym}: error {err}")
        last = (ctypes.c_long * 5)()
        lib.emu_last_launch(last)
        return last

    return call


def launch_line(name, last) -> str:
    per_sm = SM_SHARED // (last[3] + BLOCK_RESERVED)
    return (f"    {name}: grid ({last[0]}, {last[1]}), block {last[2]}, "
            f"shared {last[3]} bytes, {per_sm} blocks per SM by shared "
            "memory")


def run_riccati(lib_path: str, batch: int, plant: int, N: int,
                R: int) -> int:
    import torch
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from fsae_mpc_tpu_torch.ops.kernels import riccati as kr

    torch.set_num_threads(1)
    call = load(lib_path, kr._LIB.signatures)

    def errs(outs, refs):
        if not all(bool(torch.isfinite(o).all()) for o in outs):
            return float("inf"), float("inf")
        norm = max(float((o - r).abs().max() / r.abs().max().clamp_min(
            1e-30)) for o, r in zip(outs, refs))
        return norm, cs.inst_err(outs, refs)

    worst = {}
    for nx in kr.SUPPORTED_NX:
        for ns in kr.SUPPORTED_NS:
            if 2 * ns > R:
                continue        # each slack needs a lower and an upper row
            for K in (ns + 1, 1):
                # few rows leave each stage's Gram block rank-deficient:
                # Dr over three decades there, as chip_smoke.kernel_phase
                x = cs.kernel_inputs(batch, N, K, cs.SEED + batch + K + nx,
                                     "cpu", nx, ns, R,
                                     6.0 if R >= cs.R else 3.0)
                fac_in = (x["Ad"], x["Bd"], x["Qb"], x["Rb"], x["M"])
                asm_in = (x["C"], x["D"], x["Ws"], x["Dr"], x["qbd"],
                          x["rbd"], x["Ad"], x["Bd"])
                fac_p = kr.factor_ref(*fac_in)
                asm_p = kr.assemble_factor_ref(*asm_in)
                app = (*asm_p[:3], x["Ad"], x["Bd"], asm_p[3])
                rhs = (x["rx"], x["ru"], x["re"])
                hw_p = kr.apply_bwd_ref(*app, *rhs)
                fwd_in = app + (x["re"],) + tuple(hw_p)
                fwd_p = kr.apply_fwd_ref(*fwd_in)
                res, last = {}, {}
                outs = tuple(torch.empty_like(t) for t in fac_p)
                last["factor"] = call("riccati_factor_f32", *fac_in, *outs,
                                      batch, N, nx)
                res["factor"] = errs(outs, fac_p)
                outs = tuple(torch.empty_like(t) for t in asm_p)
                last["assemble_factor"] = call(
                    "riccati_assemble_factor_f32", *asm_in, *outs, batch, N,
                    R, nx, ns)
                res["assemble_factor"] = errs(outs, asm_p)
                outs = tuple(torch.empty_like(t) for t in hw_p)
                last["apply_bwd"] = call("riccati_apply_bwd_f32", *app,
                                         *rhs, *outs, batch, K, N, nx)
                res["apply_bwd"] = errs(outs, hw_p)
                outs = tuple(torch.empty_like(t) for t in fwd_p)
                last["apply_fwd"] = call("riccati_apply_fwd_f32", *fwd_in,
                                         *outs, batch, K, N, nx)
                res["apply_fwd"] = errs(outs, fwd_p)
                tag = f"B={batch} nx={nx} ns={ns} K={K}"
                print(f"[{tag}] " + ", ".join(
                    f"{k} {a:.2e}/{b:.2e}" for k, (a, b) in res.items()))
                for name, ll in last.items():
                    print(launch_line(name, ll))
                for k, v in res.items():
                    worst[k] = max(worst.get(k, 0.0), *v)
    print("worst (normwise or per instance): " + ", ".join(
        f"{k} {v:.3e}" for k, v in worst.items()))
    bad = [k for k, v in worst.items() if not v <= cs.KERNEL_RTOL]
    if plant:
        caught = cs.PLANT_KERNEL[plant] in bad
        print(f"planted fault {plant} ({cs.PLANTS[plant]}): "
              f"{'fails the check' if caught else 'PASSES the check'}")
        return 0 if caught else 1
    print("all within tolerance" if not bad else f"FAIL: {bad}")
    return 1 if bad else 0


def run_chol(lib_path: str, batch: int, plant: int, widths=None) -> int:
    import torch
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from fsae_mpc_tpu_torch.ops.kernels import chol as kc

    widths = widths or cs.N_DENSE
    torch.set_num_threads(1)
    call = load(lib_path, kc._LIB.signatures)

    def factor(K):
        L = torch.empty_like(K)
        last = call("chol_factor_f32", K, L, K.shape[0], K.shape[-1])
        return L, last

    def solve(L, b, launches=None):
        x = torch.empty_like(b)
        last = call("chol_solve_f32", L, b, x, b.shape[0], b.shape[-1])
        if launches is not None:
            launches.append(launch_line("chol_solve", last))
        return x

    worst = {}
    for n in widths:
        K, b = cs.spd_inputs(batch, n, cs.SEED + batch + n, "cpu")
        L_k, last = factor(K)
        L_p = kc.factor_ref(K).contiguous()
        x_p = kc.solve_ref(L_p, b)
        fac, sol = cs.chol_backward(L_p, x_p)
        lines = [launch_line("chol_factor", last)]
        res = {"chol_factor": fac(L_k),
               "chol_solve": sol(solve(L_p, b, lines)),
               "chol_solve on K6's L": sol(solve(L_k, b)),
               "chol_factor normwise": cs.rel_err(L_k, L_p)}
        print(f"[B={batch} n={n}] " + ", ".join(
            f"{k} {v:.2e}" for k, v in res.items()))
        print("\n".join(lines))
        for k, v in res.items():
            worst[k] = max(worst.get(k, 0.0), v)
    K, b = cs.chol_poison_inputs("cpu", widths[0])
    L, _ = factor(K)
    exact, clean = cs.chol_poisoned(K, L, solve(L, b))
    print(f"[NaN poison, n={widths[0]}] instances "
          f"{cs.CHOL_POISONED} NaN from their first failing pivot on: "
          f"{exact}, the others finite: {clean}")
    print("worst: " + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()))
    bad = [k for k, v in worst.items() if not v <= cs.KERNEL_RTOL]
    if plant:
        caught = (not (exact and clean) if plant == 2
                  else cs.CHOL_PLANT_KERNEL[plant] in bad)
        print(f"planted fault {plant} ({cs.CHOL_PLANTS[plant]}): "
              f"{'fails the check' if caught else 'PASSES the check'}")
        return 0 if caught else 1
    if not (exact and clean):
        bad.append("NaN poison")
    print("all within tolerance" if not bad else f"FAIL: {bad}")
    return 1 if bad else 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", choices=("riccati", "chol", "all"),
                    default="all")
    ap.add_argument("--batch", type=int, default=37)
    ap.add_argument("--stages", type=int, default=40)
    ap.add_argument("--rows", type=int, default=20)
    ap.add_argument("--n", type=int, nargs="+", help="chol.cu's widths")
    ap.add_argument("--plant", type=int, default=0)
    ap.add_argument("--chol-plant", type=int, default=0)
    ap.add_argument("--defer", action="store_true")
    ap.add_argument("--tsan", action="store_true")
    ap.add_argument("--lib", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.lib:
        if a.source == "chol":
            return run_chol(a.lib, a.batch, a.chol_plant, a.n)
        return run_riccati(a.lib, a.batch, a.plant, a.stages, a.rows)
    sources = (["riccati"] if a.plant else ["chol"] if a.chol_plant
               else ["riccati", "chol"] if a.source == "all" else [a.source])
    env = dict(os.environ)
    if a.defer:
        env["EMU_DEFER"] = "1"
    if a.tsan:
        tsan = subprocess.run(["g++", "-print-file-name=libtsan.so"],
                              capture_output=True, text=True).stdout.strip()
        env["LD_PRELOAD"] = tsan
    rc = 0
    for source in sources:
        plant = a.plant if source == "riccati" else a.chol_plant
        lib = compile_lib(source, plant, a.tsan)
        rc |= subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--lib", lib,
             "--source", source, "--batch", str(a.batch), "--plant",
             str(a.plant), "--chol-plant", str(a.chol_plant), "--stages",
             str(a.stages), "--rows", str(a.rows)]
            + (["--n", *map(str, a.n)] if a.n else []), env=env).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
