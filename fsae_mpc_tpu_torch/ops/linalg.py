"""Small dense solves of the collocation transcriptions (port of
``solve_unrolled`` of ``fsae_mpc_tpu.ops.linalg``)."""

from __future__ import annotations

import torch


def solve_unrolled(A, B):
    """Solve A X = B for small square A by unrolled Gauss-Jordan
    elimination WITHOUT pivoting, the JAX package's: a pivot below 1e-30
    in magnitude is replaced by 1e-30.  Meant for near-identity matrices
    such as the implicit collocation factors I - dt/2 A_c; a matrix that
    needs pivoting gets the reference's answer, not LAPACK's.  ``A``
    (..., n, n), ``B`` (..., n, m); returns X (..., n, m)."""
    n = A.shape[-1]
    Aw, Bw = A, B
    rows = torch.arange(n, device=A.device)
    for k in range(n):
        piv = Aw[..., k, k][..., None]
        piv = torch.where(piv.abs() < 1e-30,
                          torch.full_like(piv, 1e-30), piv)
        row_a = Aw[..., k, :] / piv
        row_b = Bw[..., k, :] / piv
        factors = Aw[..., :, k][..., None]              # (..., n, 1)
        mask = (rows == k)[:, None]
        Aw = torch.where(mask, row_a[..., None, :],
                         Aw - factors * row_a[..., None, :])
        Bw = torch.where(mask, row_b[..., None, :],
                         Bw - factors * row_b[..., None, :])
    return Bw
