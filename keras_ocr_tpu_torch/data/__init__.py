"""Training data of the port: the detector's target heatmaps."""

from . import detection_targets

__all__ = ["detection_targets"]
