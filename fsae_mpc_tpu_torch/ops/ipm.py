"""Interior-point options and presets (port of the option types of
``fsae_mpc_tpu.ops.ipm``; the dense condensed solver is not ported yet).

The stage-wise solver (``ops/riccati.py``) reads these.  Field names and
defaults are the JAX package's, so one set of options means the same thing
to both packages; the fields only the dense condensed solver reads
(``chol``, ``correctors``, ``polish*``, ``var_scale``, ``scale_kkt``,
``refine_comp``, ``comp_resid``, ``s_init``, ``z_init``) come with its
port.
"""

from __future__ import annotations

import dataclasses

import torch


def _pow2(x):
    """Round a positive scale factor DOWN to the nearest power of two.

    Scaling by exact powers of two is roundoff-free in binary floating
    point, so the scaled problem's optimum is exactly the original's.
    """
    return torch.exp2(torch.floor(torch.log2(x)))


@dataclasses.dataclass(frozen=True)
class IpmOptions:
    max_iters: int = 50
    tol: float = 5e-14          # residual tolerance on the scaled problem
    tau: float = 0.995          # fraction-to-boundary
    reg: float = 1e-9           # static KKT regularisation (relative to diag)
    adaptive: bool = True       # early exit once every instance converged
                                # (False: fixed iteration count, no host sync)
    freeze: tuple | None = None  # (pres, dres, mu) scaled thresholds past
                                # which an instance's iterate is frozen
    equilibrate: bool = True    # scale general rows by a power of two of
                                # their 2-norm
    init: str = "centered"      # "centered" | "basic"
    mu0: float = 1.0            # initial centrality target (scaled problem)
    warm_duals: str = "centered"  # "centered" | "reuse"
    warm_mu0: float = 1e-2      # centrality target for warm starts
    warm_floor: float = 1e-3    # slack/dual positivity floor ("reuse")
    refine_restart: int = 0     # delta-form restart rounds after the solve
    refine_iters: int = 10      # iteration budget per delta-form round


# float32 throughput preset: fixed 12-iteration budget, matching tolerance,
# heavier regularisation, convergence freeze.
F32_OPTS = IpmOptions(max_iters=12, tol=5e-7, reg=1e-7, adaptive=False,
                      freeze=(1e-4, 1e-5, 1e-7))

# float32 accuracy preset for the stage-wise backend: F32_OPTS plus two
# compensated delta-form restart rounds of 6 iterations each.
F32_PRODUCTION = IpmOptions(max_iters=12, tol=5e-7, reg=1e-7,
                            adaptive=False, freeze=(1e-4, 1e-5, 1e-7),
                            refine_restart=2, refine_iters=6)
