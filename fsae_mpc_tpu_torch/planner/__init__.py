"""Offline minimum-time raceline planners and the s -> t resampling of
their plans."""

from .min_time import (PlannerResult, minimum_time_planner_dynamic,  # noqa: F401
                       minimum_time_planner_kinematic)
from .reference import obtain_reference  # noqa: F401
