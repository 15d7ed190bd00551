"""Serving loops of the port: the paper's KNN service."""

from .serve import SketchKnnService

__all__ = ["SketchKnnService"]
