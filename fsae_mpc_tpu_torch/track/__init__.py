"""Track geometry: host spline fit + tensor evaluation."""

from .track import Track, load_track, track_from_points  # noqa: F401
