"""Training data of the port: augmentation, dataset loaders and image
generators, synthetic-text helpers, and the detector's target heatmaps."""

from . import augmentation, datasets, detection_targets, fonts, generation, raster

__all__ = ["augmentation", "datasets", "detection_targets", "fonts", "generation", "raster"]
