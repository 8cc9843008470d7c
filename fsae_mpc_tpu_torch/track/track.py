"""The ``Track``: arclength-parametrised closed-track geometry on tensors.

Port of ``fsae_mpc_tpu.track.track``: the spline coefficients of the host
f64 fit as tensors on one device in one dtype, with the geometry queries
the dynamics and the frame transforms need.  ``track_from_points`` and ``load_track`` put them on
the CUDA device unless the caller asks for another (``device="cpu"``).
:func:`stack_tracks` makes one batched ``Track`` of tracks fitted at the
same segment count, one track per instance of a batch (the JAX package's
stacked pytree).
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
    segment length; ``L = M * dl``: 0-d total length.  Batched (one track
    per instance): px, py (B, M, 4), dl and L (B,); the queries then take
    points (B, ...), each on its instance's track."""

    px: torch.Tensor
    py: torch.Tensor
    dl: torch.Tensor
    L: torch.Tensor

    @property
    def batched(self) -> bool:
        return self.px.ndim == 3

    def instance_dims(self) -> tuple:
        """Per field, in field order: 0 for a batch of tracks (one per
        instance), None for one track that the batch shares."""
        return (0 if self.batched else None,) * 4

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


def stack_tracks(tracks) -> Track:
    """One batched ``Track`` of ``tracks`` (``Track``s, or
    :func:`load_track`'s ``(track, raceline)`` pairs), instance b the b-th.
    They must have been fitted at the same segment count M."""
    tracks = [t[0] if isinstance(t, tuple) else t for t in tracks]
    if any(t.batched for t in tracks):
        raise ValueError("stack_tracks takes single tracks")
    ms = sorted({t.px.shape[0] for t in tracks})
    if len(ms) != 1:
        raise ValueError(f"tracks of unequal segment counts {ms} do not "
                         "stack: fit them with one n_segments")
    return Track(**{f.name: torch.stack([getattr(t, f.name) for t in tracks])
                    for f in dataclasses.fields(Track)})
