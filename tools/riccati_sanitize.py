#!/usr/bin/env python3
"""Run the Riccati kernels assemble_factor (K1) and apply_fwd (K3) under
NVIDIA's compute-sanitizer, racecheck then memcheck, on one CUDA card.

    python3 tools/riccati_sanitize.py

builds ``fsae_mpc_tpu_torch/csrc/riccati.cu``, then starts itself once per
tool under ``compute-sanitizer`` with ``--inner``, which launches each
kernel once at B=37, N=40, r=20 for every (nx, ns) the kernels take (K1,
then K3 on K1's factor with K = ns + 1 and K = 1).  Prints each tool's
summary and exits non-zero if a tool reports an error or cannot run.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = ("racecheck", "memcheck")


def inner() -> None:
    import torch
    sys.path.insert(0, ROOT)
    import chip_smoke
    from fsae_mpc_tpu_torch.ops.kernels import riccati as kr

    device = torch.device("cuda", 0)
    for nx in kr.SUPPORTED_NX:
        for ns in kr.SUPPORTED_NS:
            for K in (ns + 1, 1):
                x = chip_smoke.kernel_inputs(37, 40, K, nx + ns + K, device,
                                             nx, ns)
                fac = kr.assemble_factor_cuda(
                    x["C"], x["D"], x["Ws"], x["Dr"], x["qbd"], x["rbd"],
                    x["Ad"], x["Bd"])
                kr.apply_fwd_cuda(*fac[:3], x["Ad"], x["Bd"], fac[3],
                                  x["re"], x["ru"], x["rx"])
                torch.cuda.synchronize()
                print(f"ran nx={nx} ns={ns} K={K}", flush=True)


def main() -> int:
    sys.path.insert(0, ROOT)
    from fsae_mpc_tpu_torch.ops.kernels import build
    build.build("riccati.cu")
    san = shutil.which("compute-sanitizer") or \
        "/usr/local/cuda/bin/compute-sanitizer"
    rc = 0
    for tool in TOOLS:
        try:
            out = subprocess.run(
                [san, "--tool", tool, "--error-exitcode", "1",
                 sys.executable, os.path.abspath(__file__), "--inner"],
                capture_output=True, text=True, timeout=300)
            text, code = out.stdout + out.stderr, out.returncode
        except (OSError, subprocess.TimeoutExpired) as e:
            text, code = f"could not run: {e}", -1
        lines = text.strip().splitlines()
        print(f"== compute-sanitizer --tool {tool}: exit {code}")
        print("\n".join(lines[-25:]))
        rc = rc or (code != 0)
    return rc


if __name__ == "__main__":
    if "--inner" in sys.argv:
        inner()
    else:
        sys.exit(main())
