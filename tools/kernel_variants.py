#!/usr/bin/env python3
"""Time variant builds of the port's redesigned kernels on one CUDA card,
to see where their time goes: ``csrc/riccati.cu``'s K1 (assemble_factor),
K2 (apply_bwd), K3 (apply_fwd) and K4 (factor), and ``csrc/chol.cu``'s K6
(chol_factor) and K7 (chol_solve).

    python3 tools/kernel_variants.py [--parent DIR]

Each variant is a copy of a source with one textual change (below),
written under ``fsae_mpc_tpu_torch/build/variants/`` and built with the
port's nvcc flags, all copies in parallel.  Each is launched through its
C entry point at the main path's shapes (B=1024, N=40, nx=7, r=20, ns=4;
K2 and K3 at K=5 and K=1; K6 and K7 at n=84) on the same inputs, 3
warm-up launches then 50 between CUDA events; the error against the
plain version (per instance; K6, K7: componentwise backward error) is
printed beside the time (a variant that skips work is wrong on purpose).

``--parent DIR``: also build ``DIR/fsae_mpc_tpu_torch/csrc/riccati.cu``
(another checkout, e.g. the parent commit's) as the variant "parent", and
report whether its K1 outputs equal this tree's bit for bit on the same
inputs.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "fsae_mpc_tpu_torch", "build", "variants")

# name -> (what it measures, source, [(old, new), ...] on the source)
VARIANTS = {
    "base": ("the kernels as they are", "riccati.cu", []),
    "k1_no_recursion": (
        "K1 staging and assembly alone",
        "riccati.cu",
        [("    } else if (c >= 1) {\n      // warp 0",
          "    } else if (c >= 1 && N < 0) {\n      // warp 0")]),
    "k1_no_assembly": (
        "K1 staging and recursion alone",
        "riccati.cu",
        [("          if (item < x.ch * S::E) {",
          "          if (item < x.ch * S::E && N < 0) {")]),
    "k3_no_staging": (
        "K3 carry chain alone (no loads)",
        "riccati.cu",
        [("  for (int c = 0; c < FWD_AHEAD; ++c) {\n    if (c < nchunk) "
          "issue(c);",
          "  for (int c = 0; c < FWD_AHEAD; ++c) {\n    if (c < nchunk && "
          "N < 0) issue(c);"),
         ("if (c + FWD_AHEAD < nchunk) issue(c + FWD_AHEAD);",
          "if (c + FWD_AHEAD < nchunk && N < 0) issue(c + FWD_AHEAD);")]),
    "k3_no_chain": (
        "K3 staging alone",
        "riccati.cu",
        [("    for (int s = 0; s < ch; ++s) {\n      const int k = k0 + s;",
          "    for (int s = 0; s < ch && N < 0; ++s) {\n"
          "      const int k = k0 + s;")]),
    "k2_staging_only": (
        "K2 staging alone",
        "riccati.cu",
        [("for (int e = tid; e < ch * (NX + 1); e += nthr) {",
          "for (int e = tid; e < ch * (NX + 1) && N < 0; e += nthr) {"),
         ("    fetch(ra, s);\n    while (true) {",
          "    fetch(ra, s);\n    while (N < 0) {")]),
    "k2_no_chain": (
        "K2 staging and precompute alone",
        "riccati.cu",
        [("    fetch(ra, s);\n    while (true) {",
          "    fetch(ra, s);\n    while (N < 0) {")]),
    "k2_chain_only": (
        "K2 carry chain alone (no loads)",
        "riccati.cu",
        [("    if (c < nchunk) issue(c);\n    __pipeline_commit();       "
          "// (an empty group past the last chunk)\n  }\n  float p",
          "    if (c < nchunk && N < 0) issue(c);\n    __pipeline_commit();"
          "\n  }\n  float p"),
         ("if (c + BWD_AHEAD < nchunk) issue(c + BWD_AHEAD);",
          "if (c + BWD_AHEAD < nchunk && N < 0) issue(c + BWD_AHEAD);"),
         ("for (int e = tid; e < ch * (NX + 1); e += nthr) {",
          "for (int e = tid; e < ch * (NX + 1) && N < 0; e += nthr) {")]),
    "k4_no_recursion": (
        "K4 staging alone",
        "riccati.cu",
        [("    } else {\n      const int k0 = k0_of(c);",
          "    } else if (N < 0) {\n      const int k0 = k0_of(c);")]),
    "k4_recursion_only": (
        "K4 recursion alone (no loads)",
        "riccati.cu",
        [("  if (tid >= 32) {\n    for (int c = 0; c < F4_AHEAD; ++c) {\n"
          "      if (c < nchunk) issue(c);",
          "  if (tid >= 32) {\n    for (int c = 0; c < F4_AHEAD; ++c) {\n"
          "      if (c < nchunk && N < 0) issue(c);"),
         ("if (c + F4_AHEAD < nchunk) issue(c + F4_AHEAD);",
          "if (c + F4_AHEAD < nchunk && N < 0) issue(c + F4_AHEAD);")]),
    "k6_base": ("K6 and K7 as they are", "chol.cu", []),
    "k6_io_only": (
        "K6 loads and stores alone", "chol.cu",
        [("  for (int p = 0; p < nt; ++p) {\n    const int j0",
          "  for (int p = 0; p < nt && n < 0; ++p) {\n    const int j0")]),
    "k6_no_update": (
        "K6 loads, panels, stores", "chol.cu",
        [("t < ntiles; t += FAC_THREADS / 4)",
          "t < ntiles && n < 0; t += FAC_THREADS / 4)")]),
    "k6_no_panel": (
        "K6 loads, updates, stores", "chol.cu",
        [("    if (tid < 32) {\n      // 1. the panel",
          "    if (tid < 32 && n < 0) {\n      // 1. the panel")]),
    "k7_loads_only": (
        "K7 loads alone", "chol.cu",
        [("      for (int k = 0; k < 32 * p; ++k)",
          "      for (int k = 0; k < 32 * p && n < 0; ++k)"),
         ("    const int steps = min(32, n - 32 * p);",
          "    const int steps = n < 0 ? min(32, n - 32 * p) : 0;"),
         ("      for (int j = 32 * (p + 1); j < n; ++j)",
          "      for (int j = 32 * (p + 1); j < n && n < 0; ++j)"),
         ("    for (int jj = min(31, n - 1 - 32 * p); jj >= 0; --jj) {",
          "    for (int jj = min(31, n - 1 - 32 * p); jj >= 0 && n < 0; "
          "--jj) {")]),
    "k7_sweeps_only": (
        "K7 sweeps alone (no loads)", "chol.cu",
        [("      __pipeline_memcpy_async(T + t,",
          "      if (n < 0) __pipeline_memcpy_async(T + t,")]),
    "k7_no_overlap": (
        "K7 with every panel in before the sweeps", "chol.cu",
        [("    __pipeline_wait_prior(SOL_SLOTS - 1 - p);",
          "    __pipeline_wait_prior(0);")]),
}


def build_all() -> dict:
    sys.path.insert(0, ROOT)
    from fsae_mpc_tpu_torch.ops.kernels import build
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for name, (_, source, subs) in VARIANTS.items():
        src_dir = build.CSRC_DIR
        if name == "parent":
            src_dir = os.path.join(subs.pop(), "fsae_mpc_tpu_torch", "csrc")
        with open(os.path.join(src_dir, source)) as f:
            text = f.read()
        for old, new in subs:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: {old!r} is not in {source} once")
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
    import argparse
    import torch
    import chip_smoke as cs
    from fsae_mpc_tpu_torch.ops.kernels import chol as kc
    from fsae_mpc_tpu_torch.ops.kernels import riccati as kr

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="a checkout whose riccati.cu's K1 is "
                    "held against this tree's, bit for bit")
    parent = ap.parse_args().parent
    if parent:
        VARIANTS["parent"] = ("the other checkout's riccati.cu",
                              "riccati.cu", [os.path.abspath(parent)])
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
        bwd_in = app + (x["rx"], x["ru"], x["re"])
        hw = kr.apply_bwd_ref(*bwd_in)
        fwd_in = app + (x["re"],) + tuple(hw)
        cases[K] = (asm_in, asm_p, bwd_in, hw, fwd_in,
                    kr.apply_fwd_ref(*fwd_in))
    x = cs.kernel_inputs(B, N, 1, cs.SEED + 7, dev)
    fac_in = (x["Ad"], x["Bd"], x["Qb"], x["Rb"], x["M"])
    fac_p = kr.factor_ref(*fac_in)
    n = cs.N_DENSE[0]
    Kd, bd = cs.spd_inputs(B, n, cs.SEED + B + n, dev)
    Lp = kc.factor_ref(Kd).contiguous()
    xp = kc.solve_ref(Lp, bd)
    fac, sol = cs.chol_backward(Lp, xp)
    stream = torch.cuda.current_stream().cuda_stream
    k1_out = {}

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
        source = VARIANTS[name][1]
        mod = kr if source == "riccati.cu" else kc
        lib = ctypes.CDLL(path)
        for sym, argtypes in mod._LIB.signatures.items():
            fn = getattr(lib, sym)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        res = []
        if source == "chol.cu":
            L = torch.empty_like(Kd)
            ms = timed(lambda: lib.chol_factor_f32(
                Kd.data_ptr(), L.data_ptr(), B, n, stream))
            res.append(f"K6 n={n} {ms:.4f} ms (err {fac(L):.1e})")
            xs = torch.empty_like(bd)
            ms = timed(lambda: lib.chol_solve_f32(
                Lp.data_ptr(), bd.data_ptr(), xs.data_ptr(), B, n, stream))
            res.append(f"K7 n={n} {ms:.4f} ms (err {sol(xs):.1e})")
        else:
            outs = [torch.empty_like(t) for t in fac_p]
            fargs = [t.data_ptr() for t in (*fac_in, *outs)] + [
                B, N, cs.NX, stream]
            ms = timed(lambda: lib.riccati_factor_f32(*fargs))
            res.append(f"K4 {ms:.4f} ms "
                       f"(err {cs.inst_err(outs, fac_p):.1e})")
        for K, (asm_in, asm_p, bwd_in, bwd_p, fwd_in, fwd_p) in \
                (cases.items() if source == "riccati.cu" else ()):
            if K != 1:
                outs = [torch.empty_like(t) for t in asm_p]
                args = [t.data_ptr() for t in (*asm_in, *outs)] + [
                    B, N, cs.R, cs.NX, cs.NS, stream]
                ms = timed(lambda: lib.riccati_assemble_factor_f32(*args))
                res.append(f"K1 {ms:.4f} ms "
                           f"(err {cs.inst_err(outs, asm_p):.1e})")
                if name in ("base", "parent"):
                    k1_out[name] = outs
            outs = [torch.empty_like(t) for t in bwd_p]
            args = [t.data_ptr() for t in (*bwd_in, *outs)] + [
                B, K, N, cs.NX, stream]
            ms = timed(lambda: lib.riccati_apply_bwd_f32(*args))
            res.append(f"K2 K={K} {ms:.4f} ms "
                       f"(err {cs.inst_err(outs, bwd_p):.1e})")
            outs = [torch.empty_like(t) for t in fwd_p]
            args = [t.data_ptr() for t in (*fwd_in, *outs)] + [
                B, K, N, cs.NX, stream]
            ms = timed(lambda: lib.riccati_apply_fwd_f32(*args))
            res.append(f"K3 K={K} {ms:.4f} ms "
                       f"(err {cs.inst_err(outs, fwd_p):.1e})")
        print(f"{name:16s} {VARIANTS[name][0]:34s} " + " | ".join(res),
              flush=True)
    if "parent" in k1_out:
        same = all(torch.equal(a, b) for a, b in zip(k1_out["base"],
                                                     k1_out["parent"]))
        print(f"K1 outputs of this tree and of {parent}, same inputs: "
              f"{'bitwise equal' if same else 'DIFFER'}", flush=True)
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    sys.exit(main())
