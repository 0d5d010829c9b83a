"""Numerics guards of the train step."""

from .guards import global_norm, step_finite

__all__ = ["global_norm", "step_finite"]
