"""Cartesian <-> curvilinear frame transforms (port of
``fsae_mpc_tpu.models.transforms``), elementwise over tensors of any
shape: a batch of poses is one call.
"""

from __future__ import annotations

import math

import torch


def angdiff(a, b):
    """Signed smallest difference b - a wrapped to [-pi, pi).
    ``torch.remainder`` takes the divisor's sign, as ``jnp.mod`` does."""
    d = b - a
    return torch.remainder(d + math.pi, 2.0 * math.pi) - math.pi


def cartesian_to_curvilinear(x, y, theta, track, s_init,
                             num_iters: int = 12):
    """Project Cartesian poses onto the track.

    Returns ``(s, n, mu)``: arclength by the warm-started Newton
    projection, signed normal offset along the left normal, and heading
    deviation.
    """
    s = track.closest_point(x, y, s_init, num_iters=num_iters)
    cx, cy = track.position(s)
    tx, ty = track.tangent(s)
    inv_norm = 1.0 / torch.sqrt(tx ** 2 + ty ** 2)
    # left normal of the tangent: (-ty, tx)
    n = ((x - cx) * (-ty) + (y - cy) * tx) * inv_norm
    mu = angdiff(track.angle(s), theta)
    return s, n, mu


def curvilinear_to_cartesian(s, n, mu, track):
    """The inverse transform."""
    cx, cy = track.position(s)
    tx, ty = track.tangent(s)
    inv_norm = 1.0 / torch.sqrt(tx ** 2 + ty ** 2)
    x = cx + n * (-ty) * inv_norm
    y = cy + n * tx * inv_norm
    theta = track.angle(s) + mu
    return x, y, theta
