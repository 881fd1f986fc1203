"""Dataset loaders: the names of ``keras_ocr_tpu/datasets.py``, from
:mod:`keras_ocr_tpu_torch.data.datasets`."""

from .data.datasets import (  # noqa: F401
    get_born_digital_recognizer_dataset,
    get_cocotext_recognizer_dataset,
    get_detector_image_generator,
    get_icdar_2013_detector_dataset,
    get_icdar_2013_recognizer_dataset,
    get_icdar_2019_semisupervised_dataset,
    get_recognizer_image_generator,
)
