"""Batched dense Cholesky factor and solve: hand-written Hopper kernels +
their plain versions.

Port of ``fsae_mpc_tpu/ops/pallas/chol.py``: ``factor_lanes``
(``_factor_kernel``) and ``solve_lanes`` (``_solve_kernel``) become
``chol_factor_f32`` and ``chol_solve_f32`` in ``csrc/chol.cu``.  They
carry the dense IPM's KKT solves (``ops/ipm.py``, ``chol="auto"``).

:func:`factor` and :func:`solve` dispatch on batch-first tensors,
``K`` (B, n, n) and ``rhs`` (B, n):

  * a tensor on the CPU goes to the plain version (:func:`factor_ref`,
    :func:`solve_ref`: ``torch.linalg.cholesky_ex`` with a failed
    instance set to NaN, which is what ``jnp.linalg.cholesky`` gives on
    the CPU, and a pair of triangular solves);
  * a CUDA tensor goes to the kernel, or the call raises.  Nothing falls
    back from the card to the plain version.

A factor that meets a non-positive pivot is NaN (the kernel: from that
column on; the plain version: wholly), so its solve is NaN and the IPM's
finite-iterate rejection sees it.  The kernels read only the lower
triangle of K; the upper triangle of L is zero.  They are built with
``nvcc`` at their first launch (``build.py``) and launched on
``torch.cuda.current_stream()``; ``KERNELS[name].launches`` counts the
launches.
"""

from __future__ import annotations

import ctypes

import torch

from .build import Kernel, Library, check_tensors, empty, route

KERNELS = {
    "chol_factor": Kernel("chol_factor", "chol_factor_f32",
                          "fsae_mpc_tpu/ops/pallas/chol.py:98"),
    "chol_solve": Kernel("chol_solve", "chol_solve_f32",
                         "fsae_mpc_tpu/ops/pallas/chol.py:116"),
}

_P, _I = ctypes.c_void_p, ctypes.c_int
_LIB = Library("chol.cu", {
    "chol_factor_f32": [_P] * 2 + [_I] * 2 + [_P],
    "chol_solve_f32": [_P] * 3 + [_I] * 2 + [_P],
})


def factor_ref(K):
    """Lower Cholesky factor of each (n, n) SPD matrix; an instance whose
    factorisation fails is all NaN."""
    L, info = torch.linalg.cholesky_ex(K)
    return torch.where((info == 0)[..., None, None], L, float("nan"))


def solve_ref(L, rhs):
    """Solve L L' x = rhs per instance (forward, then back substitution)."""
    y = torch.linalg.solve_triangular(L, rhs[..., None], upper=False)
    return torch.linalg.solve_triangular(L.mT, y, upper=True)[..., 0]


def factor_cuda(K):
    Bsz, n = K.shape[:2]
    check_tensors(dict(K=K), dict(K=(Bsz, n, n)))
    L = empty(K, Bsz, n, n)
    _LIB.launch(KERNELS["chol_factor"], K, L, Bsz, n)
    return L


def solve_cuda(L, rhs):
    Bsz, n = L.shape[:2]
    check_tensors(dict(L=L, rhs=rhs), dict(L=(Bsz, n, n), rhs=(Bsz, n)))
    x = empty(rhs, Bsz, n)
    _LIB.launch(KERNELS["chol_solve"], L, rhs, x, Bsz, n)
    return x


def factor(K):
    if route(K, "Cholesky") == "ref":
        return factor_ref(K)
    return factor_cuda(K)


def solve(L, rhs):
    if route(L, "Cholesky") == "ref":
        return solve_ref(L, rhs)
    return solve_cuda(L, rhs)
