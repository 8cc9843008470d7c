"""Track geometry: host spline fit + tensor evaluation."""

from .track import (Track, load_track, stack_tracks,  # noqa: F401
                    track_from_points)
