"""Small dense solves of the collocation transcriptions (port of
``solve_unrolled`` of ``fsae_mpc_tpu.ops.linalg``), and the block placement
that Hermite-Simpson and the planners' condensed maps share."""

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


def column_blocks(t, width: int, step: int, first: int = 0):
    """A view of the block-diagonal band of ``t`` (..., K, R, C): for row
    block k, its columns ``first + k*step .. first + k*step + width``, as
    (..., K, R, width).  Index arithmetic on the strides: writing into the
    view (``copy_``, ``+=``) places K blocks at once, with no index tensor
    and no host synchronisation (the counterpart of the JAX package's
    ``vmap`` over ``lax.dynamic_update_slice``).  The caller keeps every
    block inside the row: ``first + (K-1)*step + width <= C``."""
    *lead, K, R, C = t.shape
    if K and first + (K - 1) * step + width > C:
        raise ValueError(f"column blocks past the last column: {first} + "
                         f"{K - 1}*{step} + {width} > {C}")
    st = t.stride()
    return t.as_strided((*lead, K, R, width),
                        (*st[:-3], st[-3] + step * st[-1], st[-2], st[-1]),
                        t.storage_offset() + first * st[-1])
