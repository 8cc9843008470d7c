#!/usr/bin/env python3
"""Before/after of the dense Cholesky kernels (K6 ``chol_factor_f32``,
K7 ``chol_solve_f32``) in one process on one CUDA card.

    python3 tools/chol_ab.py DIR [--n 84 81 163 192] [--batch 1024]

Builds ``DIR/fsae_mpc_tpu_torch/csrc/chol.cu`` (another checkout, e.g. an
unpacked ``git archive`` of the parent commit) and this tree's
``csrc/chol.cu`` with the port's nvcc flags, both at once, into
``fsae_mpc_tpu_torch/build/ab/``, and times each kernel through its C
entry point at each width on the same seeded SPD data
(``chip_smoke.spd_inputs``; K7 on the plain factor), from a CUDA graph of
20 launches (``chip_smoke.graph_ms``), in the order other, this, this,
other.  A width a build refuses is reported as refused.  Each launch's
componentwise backward error against the plain version
(``chip_smoke.chol_backward``) is printed beside its time.  Prints one
JSON object per (build, round, width) and the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "fsae_mpc_tpu_torch", "build", "ab")


def build(sources: dict) -> dict:
    """``{tag: chol.cu path}`` -> ``{tag: library path}``, one nvcc each,
    started together."""
    sys.path.insert(0, ROOT)
    from fsae_mpc_tpu_torch.ops.kernels import build as kbuild
    os.makedirs(OUT, exist_ok=True)
    nvcc = "/usr/local/cuda/bin/nvcc"
    procs = {tag: (os.path.join(OUT, f"libchol_{tag}.so"), subprocess.Popen(
        [nvcc, *kbuild._flags(), "-o", os.path.join(OUT, f"libchol_{tag}.so"),
         src], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for tag, src in sources.items()}
    libs = {}
    for tag, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc {tag}: {log[-3000:]}")
        print(f"build {tag}: " + " | ".join(
            ln.strip() for ln in log.splitlines() if "registers" in ln),
            flush=True)
        libs[tag] = lib
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", help="a checkout to compare with")
    ap.add_argument("--n", type=int, nargs="+", default=[84, 81, 163, 192])
    ap.add_argument("--batch", type=int, default=1024)
    a = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch
    import chip_smoke as cs
    from fsae_mpc_tpu_torch.ops.kernels import chol as kc

    if not torch.cuda.is_available():
        print("FAIL: no CUDA card")
        return 2
    libs = build({
        "other": os.path.join(os.path.abspath(a.other), "fsae_mpc_tpu_torch",
                              "csrc", "chol.cu"),
        "this": os.path.join(ROOT, "fsae_mpc_tpu_torch", "csrc", "chol.cu")})
    loaded = {}
    for tag, path in libs.items():
        lib = ctypes.CDLL(path)
        for sym, argtypes in kc._LIB.signatures.items():
            getattr(lib, sym).argtypes = argtypes
            getattr(lib, sym).restype = ctypes.c_int
        loaded[tag] = lib

    dev = torch.device("cuda", 0)
    data = {}
    for n in a.n:
        K, b = cs.spd_inputs(a.batch, n, cs.SEED + a.batch + n, dev)
        L_p = kc.factor_ref(K).contiguous()
        x_p = kc.solve_ref(L_p, b)
        data[n] = (K, b, L_p, cs.chol_backward(L_p, x_p))

    def launch(lib, sym, *args):
        conv = [t.data_ptr() if isinstance(t, torch.Tensor) else t
                for t in args]
        return getattr(lib, sym)(*conv,
                                 torch.cuda.current_stream().cuda_stream)

    card = cs.card_line()
    for rnd, tag in enumerate(("other", "this", "this", "other")):
        lib = loaded[tag]
        for n, (K, b, L_p, (fac, sol)) in data.items():
            L, x = torch.empty_like(K), torch.empty_like(b)
            rec = {"build": tag, "round": rnd, "n": n, "batch": a.batch}
            err = launch(lib, "chol_factor_f32", K, L, a.batch, n)
            err |= launch(lib, "chol_solve_f32", L_p, b, x, a.batch, n)
            torch.cuda.synchronize()
            if err:
                rec["refused"] = err
            else:
                rec.update(
                    factor_ms=cs.graph_ms(lambda: launch(
                        lib, "chol_factor_f32", K, L, a.batch, n)),
                    solve_ms=cs.graph_ms(lambda: launch(
                        lib, "chol_solve_f32", L_p, b, x, a.batch, n)),
                    factor_err=fac(L), solve_err=sol(x))
            print(json.dumps(rec), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
