"""Batched dense linear algebra from matrix products (port of
``fsae_mpc_tpu.ops.linalg``): the blocked Cholesky factor and solves that
``IpmOptions(chol="blocked")`` routes the dense IPM's KKT systems to, the
small dense solves of the collocation transcriptions
(:func:`solve_unrolled`), and the block placement that Hermite-Simpson
and the planners' condensed maps share (:func:`column_blocks`).

The blocked Cholesky launches no hand kernel: it is plain PyTorch, batched
over every leading dimension.  Diagonal blocks factor by a recursion that
halves them down to a column recursion on at most 8 columns; the
triangular solves run on the inverted diagonal blocks, so each is a chain
of batched matrix products.  A pivot is clamped, as in the JAX package:
``sqrt(max(s, 1e-30))``, so an indefinite matrix gives a finite (and
meaningless) factor where the hand kernel K6 gives NaN.
"""

from __future__ import annotations

import torch

from .precision import highest as _highest_precision


# ---------------------------------------------------------------------------
# blocked Cholesky
# ---------------------------------------------------------------------------


def _chol_base(A):
    """Cholesky of a tiny (..., b, b) SPD block by the column recursion,
    each pivot clamped at 1e-30 before its square root."""
    b = A.shape[-1]
    cols = []
    for j in range(b):
        s = A[..., :, j]
        for Lk in cols:
            s = s - Lk * Lk[..., j][..., None]
        d = torch.sqrt(torch.clamp_min(s[..., j], 1e-30))
        col = s / d[..., None]
        col[..., :j] = 0.0                   # the strictly upper part
        cols.append(col)
    return torch.stack(cols, -1)


def _tri_inv_unrolled(L):
    """Inverse of a tiny lower-triangular (..., b, b) block by forward
    substitution, row by row: X[i] = (e_i - L[i, :i] X[:i]) / L[i, i]."""
    b = L.shape[-1]
    eye = torch.eye(b, dtype=L.dtype, device=L.device)
    rows = []
    for i in range(b):
        r = eye[i].expand(L.shape[:-1])
        if i:
            r = r - (L[..., i:i + 1, :i] @ torch.stack(rows, -2))[..., 0, :]
        rows.append(r / L[..., i, i][..., None])
    return torch.stack(rows, -2)


def _tri_inv_lower_small(L, base: int = 8):
    """Inverse of a lower-triangular (..., b, b) block, recursively:

        inv([[A, 0], [B, C]]) = [[Ainv, 0], [-Cinv B Ainv, Cinv]]
    """
    b = L.shape[-1]
    if b <= base:
        return _tri_inv_unrolled(L)
    h = b // 2
    Ai = _tri_inv_lower_small(L[..., :h, :h], base)
    Ci = _tri_inv_lower_small(L[..., h:, h:], base)
    BL = -(Ci @ (L[..., h:, :h] @ Ai))
    top = torch.cat([Ai, Ai.new_zeros(Ai.shape[:-2] + (h, b - h))], -1)
    return torch.cat([top, torch.cat([BL, Ci], -1)], -2)


def _tri_solve_lower_small(L, B):
    """Solve L X = B for a small lower-triangular L; B is (..., b, m)."""
    return _tri_inv_lower_small(L) @ B


def _tri_solve_upper_small(U, B):
    """Solve U X = B for a small upper-triangular U; B is (..., b, m)."""
    return _tri_inv_lower_small(U.mT).mT @ B


def _chol_unblocked(A, base: int = 8):
    """Cholesky of a small (..., b, b) SPD block, recursively:

        chol([[A11, .], [A21, A22]]) = [[L11, 0], [A21 L11^-T, chol(S)]]

    with S = A22 - L21 L21^T, down to :func:`_chol_base` at ``base``."""
    b = A.shape[-1]
    if b <= base:
        return _chol_base(A)
    h = b // 2
    L11 = _chol_unblocked(A[..., :h, :h], base)
    L21 = A[..., h:, :h] @ _tri_inv_lower_small(L11, base).mT
    L22 = _chol_unblocked(A[..., h:, h:] - L21 @ L21.mT, base)
    top = torch.cat([L11, L11.new_zeros(L11.shape[:-2] + (h, b - h))], -1)
    return torch.cat([top, torch.cat([L21, L22], -1)], -2)


def _pick_block(n: int) -> int:
    for b in (32, 28, 24, 16, 12, 8):
        if n % b == 0:
            return b
    return n


@_highest_precision
def cholesky(A, block: int | None = None):
    """Blocked right-looking Cholesky of (..., n, n) SPD A -> lower L.

    Diagonal blocks factor with :func:`_chol_unblocked`, panels by small
    triangular solves, trailing updates by batched matrix products.  An n
    that ``block`` does not divide is padded with the identity."""
    n = A.shape[-1]
    if block is None:
        block = _pick_block(n)
    if n <= block:
        return _chol_unblocked(A)
    nb = -(-n // block)
    n_pad = nb * block
    Awork = A.new_zeros(A.shape[:-2] + (n_pad, n_pad))
    Awork[..., :n, :n] = A
    if n_pad != n:
        idx = torch.arange(n, n_pad, device=A.device)
        Awork[..., idx, idx] = 1.0
    L = torch.zeros_like(Awork)
    for k in range(nb):
        lo, hi = k * block, (k + 1) * block
        Lkk = _chol_unblocked(Awork[..., lo:hi, lo:hi])
        L[..., lo:hi, lo:hi] = Lkk
        if hi < n_pad:
            # X Lkk^T = panel  <=>  Lkk X^T = panel^T
            X = _tri_solve_lower_small(Lkk, Awork[..., hi:, lo:hi].mT).mT
            L[..., hi:, lo:hi] = X
            Awork[..., hi:, hi:] = Awork[..., hi:, hi:] - X @ X.mT
    return L[..., :n, :n] if n_pad != n else L


@_highest_precision
def cho_solve(L, rhs, block: int | None = None):
    """Solve A x = rhs from the blocked factor L of :func:`cholesky`.
    ``rhs`` (..., n) or (..., n, m)."""
    vec = rhs.ndim == L.ndim - 1
    if vec:
        rhs = rhs[..., None]
    n = L.shape[-1]
    if block is None:
        block = _pick_block(n)
    nb = -(-n // block)
    span = [(k * block, min((k + 1) * block, n)) for k in range(nb)]
    y = []                                   # forward: L y = rhs
    for k, (lo, hi) in enumerate(span):
        r = rhs[..., lo:hi, :]
        for (jlo, jhi), yb in zip(span, y):
            r = r - L[..., lo:hi, jlo:jhi] @ yb
        y.append(_tri_solve_lower_small(L[..., lo:hi, lo:hi], r))
    x = [None] * nb                          # backward: L^T x = y
    for k in reversed(range(nb)):
        lo, hi = span[k]
        r = y[k]
        for j in range(k + 1, nb):
            jlo, jhi = span[j]
            r = r - L[..., jlo:jhi, lo:hi].mT @ x[j]
        x[k] = _tri_solve_upper_small(L[..., lo:hi, lo:hi].mT, r)
    out = torch.cat(x, -2)
    return out[..., 0] if vec else out


@_highest_precision
def cholesky_invdiag(A, block: int | None = None):
    """Blocked Cholesky that also returns the inverted diagonal blocks, so
    that the triangular solves are matrix products only.  Returns
    ``(L, Dinv)`` with ``Dinv`` (..., nb, b, b).  ``block`` must divide n
    (the default always does: it falls back to one block of n)."""
    n = A.shape[-1]
    if block is None:
        block = _pick_block(n)
    if n % block:
        raise ValueError(f"cholesky_invdiag needs n divisible by block "
                         f"(n={n}, block={block})")
    nb = n // block
    Awork = A.clone()
    L = torch.zeros_like(A)
    Dinvs = []
    for k in range(nb):
        lo, hi = k * block, (k + 1) * block
        Lkk = _chol_unblocked(Awork[..., lo:hi, lo:hi])
        Dinv = _tri_inv_lower_small(Lkk)
        Dinvs.append(Dinv)
        L[..., lo:hi, lo:hi] = Lkk
        if hi < n:
            # X Lkk^T = panel  =>  X = panel Lkk^-T
            X = Awork[..., hi:, lo:hi] @ Dinv.mT
            L[..., hi:, lo:hi] = X
            Awork[..., hi:, hi:] = Awork[..., hi:, hi:] - X @ X.mT
    return L, torch.stack(Dinvs, -3)


@_highest_precision
def cho_solve_invdiag(L, Dinv, rhs, block: int | None = None):
    """Solve A x = rhs from :func:`cholesky_invdiag`'s factors by matrix
    products only.  ``rhs`` (..., n) or (..., n, m)."""
    vec = rhs.ndim == L.ndim - 1
    if vec:
        rhs = rhs[..., None]
    n = L.shape[-1]
    if block is None:
        block = _pick_block(n)
    nb = n // block
    y = []                                   # forward: L y = rhs
    for k in range(nb):
        lo, hi = k * block, (k + 1) * block
        r = rhs[..., lo:hi, :]
        for j, yb in enumerate(y):
            r = r - L[..., lo:hi, j * block:(j + 1) * block] @ yb
        y.append(Dinv[..., k, :, :] @ r)
    x = [None] * nb                          # backward: L^T x = y
    for k in reversed(range(nb)):
        lo, hi = k * block, (k + 1) * block
        r = y[k]
        for j in range(k + 1, nb):
            r = r - L[..., j * block:(j + 1) * block, lo:hi].mT @ x[j]
        x[k] = Dinv[..., k, :, :].mT @ r
    out = torch.cat(x, -2)
    return out[..., 0] if vec else out


# ---------------------------------------------------------------------------
# small dense solves and block placement
# ---------------------------------------------------------------------------


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
