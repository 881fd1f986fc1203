"""keras-ocr on PyTorch and CUDA: the port of :mod:`keras_ocr_tpu`.

It imports ``torch``, ``numpy`` and the standard library only. The JAX
package stays the reference the port is tested against.
"""

from . import data, detection, evaluation, pipeline, recognition, tools, train
from .detection import Detector
from .pipeline import ExportedPipeline, Pipeline, load_exported
from .recognition import Recognizer

__all__ = [
    "Detector", "ExportedPipeline", "Pipeline", "Recognizer", "data", "detection",
    "evaluation", "load_exported", "pipeline", "recognition", "tools", "train",
]
