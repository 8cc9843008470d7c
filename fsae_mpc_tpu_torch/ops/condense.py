"""Condensing: stage-wise affine dynamics -> dense prediction matrices
(port of ``condense`` and ``rollout`` of ``fsae_mpc_tpu.ops.condense``).

Inputs are the discrete stage matrices (x_{k+1} = Ad x_k + Bd u_k + dd),
batch first.  :func:`condense` is the horizon recurrence written as a
plain loop over the N stages, the plain version of the hand-written
kernel in ``ops/kernels/condense.py``.
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
