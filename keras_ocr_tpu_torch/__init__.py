"""keras-ocr on PyTorch and CUDA: the port of :mod:`keras_ocr_tpu`.

It imports ``torch``, ``numpy``, ``scipy`` (the data modules, as the JAX
package's use it) and the standard library only. The JAX package stays the
reference the port is tested against.
"""

from . import config
from . import (data, data_generation, datasets, detection, evaluation, models, native, ops,
               parallel, pipeline, recognition, tools, train, utils, weights)
from .detection import Detector
from .pipeline import ExportedPipeline, Pipeline, load_exported
from .recognition import Recognizer

__all__ = [
    "Detector", "ExportedPipeline", "Pipeline", "Recognizer", "config", "data",
    "data_generation", "datasets", "detection", "evaluation", "load_exported", "models",
    "native", "ops", "parallel", "pipeline", "recognition", "tools", "train", "utils", "weights",
]
