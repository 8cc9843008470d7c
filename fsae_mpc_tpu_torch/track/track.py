"""The ``Track``: arclength-parametrised closed-track geometry on tensors.

Port of ``fsae_mpc_tpu.track.track``: the spline coefficients of the host
f64 fit as tensors on one device in one dtype, with the geometry queries
the dynamics and the frame transforms need.  ``track_from_points`` and ``load_track`` put them on
the CUDA device unless the caller asks for another (``device="cpu"``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import spline as sp
from ..utils.io import read_raceline_csv


@dataclasses.dataclass(frozen=True)
class Track:
    """``px``/``py``: (M, 4) Bezier coefficients; ``dl``: 0-d nominal
    segment length; ``L = M * dl``: 0-d total length."""

    px: torch.Tensor
    py: torch.Tensor
    dl: torch.Tensor
    L: torch.Tensor

    def position(self, s):
        return (sp.interpolate(s, self.px, self.dl),
                sp.interpolate(s, self.py, self.dl))

    def tangent(self, s):
        return (sp.interpolate_d(s, self.px, self.dl),
                sp.interpolate_d(s, self.py, self.dl))

    def angle(self, s):
        return sp.angle(s, self.px, self.py, self.dl)

    def curvature(self, s):
        return sp.curvature(s, self.px, self.py, self.dl)

    def curvature_d(self, s):
        return sp.curvature_d(s, self.px, self.py, self.dl)

    def closest_point(self, x, y, s_init, num_iters: int = 12):
        return sp.closest_point(x, y, self.px, self.py, self.dl, s_init,
                                num_iters=num_iters)

    def to(self, device=None, dtype=None) -> "Track":
        return Track(**{f.name: getattr(self, f.name).to(device=device,
                                                          dtype=dtype)
                        for f in dataclasses.fields(self)})


def track_from_points(x: np.ndarray, y: np.ndarray, n_segments: int = 100,
                      periodic: bool = True, dtype=torch.float32,
                      device="cuda") -> Track:
    """Fit + arclength-reparametrise a track through centreline points."""
    x_P = sp.make_spline_periodic(x) if periodic else sp.make_spline(x)
    y_P = sp.make_spline_periodic(y) if periodic else sp.make_spline(y)
    x_P, y_P, dl, L = sp.arclength_reparam(x_P, y_P, n_segments, periodic)
    as_t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    return Track(px=as_t(x_P), py=as_t(y_P), dl=as_t(dl), L=as_t(L))


def load_track(csv_path: str, n_segments: int = 100, dtype=torch.float32,
               device="cuda"):
    """Load a raceline CSV and build the ``Track``.  Returns
    ``(track, raceline_dict)``."""
    cols = read_raceline_csv(csv_path)
    track = track_from_points(cols["x"], cols["y"], n_segments=n_segments,
                              dtype=dtype, device=device)
    return track, cols
