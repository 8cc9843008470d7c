"""Headless visualisation of closed-loop runs (port of
``fsae_mpc_tpu.utils.viz``): the lap overview, one tick's predicted
trajectory over the track, and the telemetry traces, rendered to files
with matplotlib's Agg backend.

matplotlib is imported by the plotting functions, never with this module:
a machine without it (the card's) imports the port whole.  The port's
outputs are batched; each function plots one instance (``instance``) and
that instance's track.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models import transforms
from . import tree as tree_util


def _pyplot():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _instance_track(track, instance: int):
    return (tree_util.map(lambda t: t[instance], track) if track.batched
            else track)


def _np(t):
    return t.detach().cpu().numpy()


def plot_lap(track, sim_out, raceline=None, path="lap.png", title=None,
             instance: int = 0):
    """Lap overview: track centreline, cones, and the driven trajectory of
    one instance.

    ``sim_out``: a ``SimOutputs``; ``raceline``: optional dict from
    ``read_raceline_csv`` with rx/ry/lx/ly cone lines.
    """
    plt = _pyplot()
    track = _instance_track(track, instance)
    s = torch.linspace(0.0, float(track.L), 800, dtype=track.px.dtype,
                       device=track.px.device)
    cx, cy = track.position(s)

    fig, ax = plt.subplots(figsize=(9, 7))
    ax.plot(_np(cx), _np(cy), "k-", lw=0.8, label="centreline")
    if raceline is not None:
        ax.plot(raceline["rx"], raceline["ry"], "y.", ms=3,
                label="right cones")
        ax.plot(raceline["lx"], raceline["ly"], "b.", ms=3,
                label="left cones")

    x = _np(sim_out.x_history[instance])
    act = _np(sim_out.active[instance])
    ax.plot(x[act, 0], x[act, 1], "r--", lw=1.2, label="driven")
    ax.set_aspect("equal")
    ax.legend(loc="best", fontsize=8)
    if title:
        ax.set_title(title)
    fig.tight_layout()
    fig.savefig(path, dpi=130)
    plt.close(fig)
    return path


def plot_prediction(track, x_cart, x_opt_curv, path="pred.png",
                    instance: int = 0):
    """One tick's predicted trajectory over the track: the predicted
    curvilinear states ``x_opt_curv`` (N, nx) converted back to Cartesian
    and overlaid on the local track segment, with the car at ``x_cart``
    (7,)."""
    plt = _pyplot()
    track = _instance_track(track, instance)
    px, py, _ = transforms.curvilinear_to_cartesian(
        x_opt_curv[:, 0], x_opt_curv[:, 1], x_opt_curv[:, 2], track)

    span = torch.linspace(float(x_opt_curv[0, 0]) - 10.0,
                          float(x_opt_curv[-1, 0]) + 10.0, 200,
                          dtype=track.px.dtype, device=track.px.device)
    cx, cy = track.position(span)

    fig, ax = plt.subplots(figsize=(7, 6))
    ax.plot(_np(cx), _np(cy), "k-", lw=0.8)
    ax.plot(_np(px), _np(py), "g.-", ms=4, label="prediction")
    ax.plot([float(x_cart[0])], [float(x_cart[1])], "r*", ms=12, label="car")
    ax.set_aspect("equal")
    ax.legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(path, dpi=130)
    plt.close(fig)
    return path


def plot_telemetry(sim_out, dt=0.05, path="telemetry.png",
                   instance: int = 0):
    """Velocity / steering / lateral-offset traces of one instance."""
    plt = _pyplot()
    x = _np(sim_out.x_history[instance])
    act = _np(sim_out.active[instance])
    t = np.arange(x.shape[0]) * dt

    fig, axes = plt.subplots(3, 1, figsize=(9, 7), sharex=True)
    axes[0].plot(t[act], x[act, 3])
    axes[0].set_ylabel("v_x [m/s]")
    axes[1].plot(t[act], x[act, 6])
    axes[1].set_ylabel("delta [rad]")
    axes[2].plot(t[act], _np(sim_out.n_history[instance])[act])
    axes[2].axhline(0.75, color="r", ls=":", lw=0.8)
    axes[2].axhline(-0.75, color="r", ls=":", lw=0.8)
    axes[2].set_ylabel("n [m]")
    axes[2].set_xlabel("t [s]")
    fig.tight_layout()
    fig.savefig(path, dpi=130)
    plt.close(fig)
    return path
