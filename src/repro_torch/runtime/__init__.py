"""Runtime services of the port (so far: serving-side elastic scale-down)."""

from .elastic import scale_down_plan

__all__ = ["scale_down_plan"]
