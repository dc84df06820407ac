"""Renderers of tracks and scenes: the port of shasta_tpu/viz/."""
from .visualizer2d import Visualizer2D  # noqa: F401
