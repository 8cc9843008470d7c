"""Condensing: stage-wise affine dynamics -> dense prediction matrices
(port of ``condense``, ``condense_associative``, ``condense_general`` and
``rollout`` of ``fsae_mpc_tpu.ops.condense``).

Inputs are the discrete stage matrices (x_{k+1} = Ad x_k + Bd u_k + dd),
batch first.  :func:`condense` is the horizon recurrence written as a
plain loop over the N stages, the plain version of the hand-written
kernel in ``ops/kernels/condense.py``.  :func:`condense_general` (the
collocation transcriptions' multi-control recurrence) and
:func:`condense_associative` (the transition products in log depth) have
no TPU kernel in the JAX package and stay plain PyTorch.
"""

from __future__ import annotations

import torch

from .precision import highest as _highest_precision


@_highest_precision
def condense(Ad, Bd, dd):
    """Build dense prediction matrices.

    Args:
      Ad: (B, N, nx, nx), Bd: (B, N, nx, nu), dd: (B, N, nx)

    Returns:
      A_bar: (B, N, nx, nx)      with  A_bar[i] = Ad_i ... Ad_0
      B_bar: (B, N, nx, N*nu)    lower-block-triangular: x_i sensitivity
                                 to u_j
      d_bar: (B, N, nx)          accumulated affine offsets

    such that  x_{i+1} = A_bar[i] x_0 + B_bar[i] u_flat + d_bar[i].
    """
    Bsz, N, nx, nu = Bd.shape
    phi = torch.eye(nx, dtype=Ad.dtype, device=Ad.device).expand(Bsz, nx,
                                                                 nx)
    G = torch.zeros((Bsz, nx, N * nu), dtype=Ad.dtype, device=Ad.device)
    delta = torch.zeros((Bsz, nx), dtype=Ad.dtype, device=Ad.device)
    A_bar, B_bar, d_bar = [], [], []
    for i in range(N):
        A = Ad[:, i]
        phi = A @ phi
        G = A @ G                   # a new tensor: the stored G_{i-1} stays
        G[:, :, i * nu:(i + 1) * nu] = Bd[:, i]
        delta = torch.einsum("bij,bj->bi", A, delta) + dd[:, i]
        A_bar.append(phi)
        B_bar.append(G)
        d_bar.append(delta)
    return torch.stack(A_bar, 1), torch.stack(B_bar, 1), torch.stack(d_bar, 1)


@_highest_precision
def condense_associative(Ad, dd):
    """The transition and offset products in log depth: the pair
    (Phi_i, delta_i) composes associatively, (A2, d2) o (A1, d1) =
    (A2 A1, A2 d1 + d2), so ceil(log2 N) rounds of a Hillis-Steele
    inclusive scan over the stage axis give every prefix (the JAX
    package's ``lax.associative_scan``, another tree of the same
    products).  ``Ad`` (..., N, nx, nx), ``dd`` (..., N, nx).  Returns
    (A_bar, d_bar) as :func:`condense`.
    """
    A, d = Ad, dd
    N = Ad.shape[-3]
    w = 1
    while w < N:
        A_w = A[..., w:, :, :]
        d = torch.cat([d[..., :w, :], torch.einsum(
            "...ij,...j->...i", A_w, d[..., :-w, :]) + d[..., w:, :]], -2)
        A = torch.cat([A[..., :w, :, :], A_w @ A[..., :-w, :, :]], -3)
        w *= 2
    return A, d


@_highest_precision
def condense_general(Ad, dd, B_terms, n_controls: int,
                     ctrl_stride: int = 1):
    """Condensing of a recurrence whose step couples several controls:

        x_{i+1} = Ad_i x_i + sum_k Bd_k[i] u_{i*ctrl_stride + off_k} + dd_i

    ``Ad`` (B, N, nx, nx), ``dd`` (B, N, nx); ``B_terms``: a list of
    ``(Bd (B, N, nx, nu), off)``; ``n_controls``: the length of the
    control trajectory.  Trapezoidal collocation couples u_i and u_{i+1}
    (stride 1), Hermite-Simpson (u_2i, u_2i+1, u_2i+2) (stride 2).

    Returns (A_bar (B, N, nx, nx), B_bar (B, N, nx, n_controls*nu),
    d_bar (B, N, nx)).
    """
    Bsz, N, nx = dd.shape
    nu = B_terms[0][0].shape[-1]
    phi = torch.eye(nx, dtype=Ad.dtype, device=Ad.device).expand(Bsz, nx,
                                                                 nx)
    G = torch.zeros((Bsz, nx, n_controls * nu), dtype=Ad.dtype,
                    device=Ad.device)
    delta = torch.zeros((Bsz, nx), dtype=Ad.dtype, device=Ad.device)
    A_bar, B_bar, d_bar = [], [], []
    for i in range(N):
        A = Ad[:, i]
        phi = A @ phi
        G = A @ G                   # a new tensor: the stored G_{i-1} stays
        for Bd, off in B_terms:
            col = (i * ctrl_stride + off) * nu
            G[:, :, col:col + nu] += Bd[:, i]
        delta = torch.einsum("bij,bj->bi", A, delta) + dd[:, i]
        A_bar.append(phi)
        B_bar.append(G)
        d_bar.append(delta)
    return torch.stack(A_bar, 1), torch.stack(B_bar, 1), torch.stack(d_bar, 1)


@_highest_precision
def rollout(Ad, Bd, dd, x0, u):
    """Apply the stage dynamics directly: x_{i+1} = Ad_i x_i + Bd_i u_i +
    dd_i from ``x0`` (B, nx) under ``u`` (B, N, nu).  Returns (B, N, nx)."""
    xs = []
    xk = x0
    for k in range(Ad.shape[1]):
        xk = (torch.einsum("bij,bj->bi", Ad[:, k], xk)
              + torch.einsum("bik,bk->bi", Bd[:, k], u[:, k]) + dd[:, k])
        xs.append(xk)
    return torch.stack(xs, 1)
