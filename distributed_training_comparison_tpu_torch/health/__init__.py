"""Numerics guards of the train step."""

from .guards import global_norm, select_tree, step_finite

__all__ = ["global_norm", "select_tree", "step_finite"]
