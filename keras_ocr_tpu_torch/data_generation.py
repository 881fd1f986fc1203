"""Synthetic data generation: the names of ``keras_ocr_tpu/data_generation.py``,
from :mod:`keras_ocr_tpu_torch.data.generation`, with ``compute_maps`` and
``map_to_rgb`` from :mod:`keras_ocr_tpu_torch.data.detection_targets`."""

from .data.detection_targets import compute_maps, map_to_rgb  # noqa: F401
from .data.generation import (  # noqa: F401
    LIGATURE_STRING,
    LIGATURES,
    compute_transformed_contour,
    convert_image_generator_to_recognizer_input,
    convert_lines_to_paragraph,
    draw_text_image,
    font_supports_alphabet,
    get_backgrounds,
    get_fonts,
    get_image_generator,
    get_maximum_uniform_contour,
    get_rotation_matrix,
    get_text_generator,
)
