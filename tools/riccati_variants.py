#!/usr/bin/env python3
"""Time variant builds of ``csrc/riccati.cu``'s K1 (assemble_factor) and K3
(apply_fwd) on one CUDA card, to see where their time goes.

    python3 tools/riccati_variants.py

Each variant is a copy of the source with one textual change (below),
written under ``fsae_mpc_tpu_torch/build/variants/`` and built with the
port's nvcc flags, all copies in parallel.  Each is launched through its
C entry point at the main path's shapes (B=1024, N=40, nx=7, r=20, ns=4;
K3 at K=5 and K=1) on the same inputs, 3 warm-up launches then 50 between
CUDA events; the error per instance against the plain version is printed
beside the time (a variant that skips work is wrong on purpose).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "fsae_mpc_tpu_torch", "build", "variants")

# name -> (what it measures, [(old, new), ...] on the source)
VARIANTS = {
    "base": ("the kernels as they are", []),
    "k1_no_recursion": (
        "K1 staging and assembly alone",
        [("    } else if (c >= 1) {\n      // warp 0",
          "    } else if (c >= 1 && N < 0) {\n      // warp 0")]),
    "k1_no_assembly": (
        "K1 staging and recursion alone",
        [("          if (item < x.ch * S::E) {",
          "          if (item < x.ch * S::E && N < 0) {")]),
    "k3_no_staging": (
        "K3 carry chain alone (no loads)",
        [("    stage_async(f + L.hi, Huinv",
          "    if (N < 0) stage_async(f + L.hi, Huinv")]
        + [(f"    stage_async(f + L.{r}, ", f"    if (N < 0) stage_async(f + L.{r}, ")
           for r in ("g", "w", "a", "b", "m")]
        + [(f"      stage_async(rr + L.{r}, ", f"      if (N < 0) stage_async(rr + L.{r}, ")
           for r in ("re", "h", "wv")]),
    "k3_no_chain": (
        "K3 staging alone",
        [("    for (int s = 0; s < ch; ++s) {\n      const int k = k0 + s;",
          "    for (int s = 0; s < ch && N < 0; ++s) {\n"
          "      const int k = k0 + s;")]),
}


def build_all() -> dict:
    sys.path.insert(0, ROOT)
    from fsae_mpc_tpu_torch.ops.kernels import build
    with open(os.path.join(build.CSRC_DIR, "riccati.cu")) as f:
        src = f.read()
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for name, (_, subs) in VARIANTS.items():
        text = src
        for old, new in subs:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: {old!r} is not in the source once")
            text = text.replace(old, new)
        cu = os.path.join(OUT, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            ["/usr/local/cuda/bin/nvcc", *build.NVCC_FLAGS, "-o",
             cu[:-3] + ".so", cu], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{out[-3000:]}")
    return {name: os.path.join(OUT, f"{name}.so") for name in VARIANTS}


def main() -> int:
    import torch
    import chip_smoke as cs
    from fsae_mpc_tpu_torch.ops.kernels import riccati as kr

    libs = build_all()
    dev = torch.device("cuda", 0)
    B, N = cs.B_MAIN, cs.N_MAIN
    cases = {}
    for K in (cs.NS + 1, 1):
        x = cs.kernel_inputs(B, N, K, cs.SEED + K, dev)
        asm_in = (x["C"], x["D"], x["Ws"], x["Dr"], x["qbd"], x["rbd"],
                  x["Ad"], x["Bd"])
        asm_p = kr.assemble_factor_ref(*asm_in)
        app = (*asm_p[:3], x["Ad"], x["Bd"], asm_p[3])
        hw = kr.apply_bwd_ref(*app, x["rx"], x["ru"], x["re"])
        fwd_in = app + (x["re"],) + tuple(hw)
        cases[K] = (asm_in, asm_p, fwd_in, kr.apply_fwd_ref(*fwd_in))
    stream = torch.cuda.current_stream().cuda_stream

    def timed(fn, reps=50):
        for _ in range(3):
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

    for name, path in libs.items():
        lib = ctypes.CDLL(path)
        for sym, argtypes in kr._LIB.signatures.items():
            fn = getattr(lib, sym)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        res = []
        for K, (asm_in, asm_p, fwd_in, fwd_p) in cases.items():
            if K != 1:
                outs = [torch.empty_like(t) for t in asm_p]
                args = [t.data_ptr() for t in (*asm_in, *outs)] + [
                    B, N, cs.R, cs.NX, cs.NS, stream]
                ms = timed(lambda: lib.riccati_assemble_factor_f32(*args))
                res.append(f"K1 {ms:.4f} ms (err {cs.inst_err(outs, asm_p):.1e})")
            outs = [torch.empty_like(t) for t in fwd_p]
            args = [t.data_ptr() for t in (*fwd_in, *outs)] + [
                B, K, N, cs.NX, stream]
            ms = timed(lambda: lib.riccati_apply_fwd_f32(*args))
            res.append(f"K3 K={K} {ms:.4f} ms "
                       f"(err {cs.inst_err(outs, fwd_p):.1e})")
        print(f"{name:16s} {VARIANTS[name][0]:34s} " + " | ".join(res),
              flush=True)
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    sys.exit(main())
