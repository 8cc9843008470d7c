"""s -> t resampling of a minimum-time plan, batch-first (port of
``fsae_mpc_tpu.planner.reference``).

The planner gives node states and per-node traversal times over the
lap's arclength; a tracking MPC needs its reference at the times of its
horizon.  The cumulative node times are searched for each query time
(``torch.searchsorted`` on the device, no host synchronisation) and the
node states interpolated linearly by the elapsed-time fraction, for every
instance's own position at once.
"""

from __future__ import annotations

import torch


def obtain_reference(y_nodes, u_nodes, t_nodes, ds, s0, dt, n_steps: int):
    """Resample a periodic s-domain plan in time.

    Args:
      y_nodes: (N, ny) node states (the dynamic planner's [n, mu, x_d,
        y_d, theta_d, delta]).
      u_nodes: (N, nu) node controls (not read; kept for the JAX
        package's signature).
      t_nodes: (N,) per-node traversal times ``ds / s_dot``.
      ds: node spacing in s (a float or a 0-d tensor).
      s0: (B,) each instance's arclength position.
      dt: the MPC step; n_steps: the horizon.

    Returns:
      (B, n_steps, 1 + ny): rows ``[s, *y]`` at times k*dt after s0,
      k = 1..n_steps, with s unwrapped to increase from s0.
    """
    N = t_nodes.shape[0]
    L = ds * N
    T_cum = torch.cat([torch.zeros_like(t_nodes[:1]),
                       torch.cumsum(t_nodes, 0)])
    T_lap = T_cum[-1]

    # the starting node and fraction from s0
    s_wrap = torch.remainder(s0, L)
    idx0 = torch.clamp(torch.floor(s_wrap / ds).to(torch.int64), 0, N - 1)
    rto0 = s_wrap / ds - idx0
    tau0 = T_cum[idx0] + rto0 * t_nodes[idx0]

    # the query times, wrapped onto the lap
    k = torch.arange(1, n_steps + 1, dtype=t_nodes.dtype,
                     device=t_nodes.device)
    tau = torch.remainder(tau0[:, None] + k * dt, T_lap)
    j = torch.clamp(torch.searchsorted(T_cum, tau, right=True) - 1, 0,
                    N - 1)
    rto = (tau - T_cum[j]) / t_nodes[j]

    # the arclength progressed since (idx0, rto0), unwrapped
    prog = torch.remainder((j + rto) - (idx0 + rto0)[:, None], N) * ds
    s_ref = s0[:, None] + prog

    y_j = y_nodes[j]
    y_nxt = y_nodes[torch.remainder(j + 1, N)]
    y_ref = y_j + (y_nxt - y_j) * rto[..., None]
    return torch.cat([s_ref[..., None], y_ref], -1)
