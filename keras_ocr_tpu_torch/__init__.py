"""keras-ocr on PyTorch and CUDA: the port of :mod:`keras_ocr_tpu`.

It imports ``torch``, ``numpy``, ``scipy`` (the data modules, as the JAX
package's use it) and the standard library only. The JAX package stays the
reference the port is tested against.
"""

from . import (data, data_generation, datasets, detection, evaluation, native, parallel, pipeline,
               recognition, tools, train)
from .detection import Detector
from .pipeline import ExportedPipeline, Pipeline, load_exported
from .recognition import Recognizer

__all__ = [
    "Detector", "ExportedPipeline", "Pipeline", "Recognizer", "data", "data_generation",
    "datasets", "detection", "evaluation", "load_exported", "native", "parallel", "pipeline",
    "recognition", "tools", "train",
]
