"""Port parity of the BN-folded golden pipeline: JAX's ``Pipeline`` with
``Detector(fold_bn=True)`` on the folded checkpoint (``fold_bn_variables``)
and the port's, which folds the standard checkpoint on load, read the same
words on the same scenes, every box at IoU > 0.9, with the same escalation
steps (the checks of ``tests/test_torch_export.py``), on each of the
golden artifact's 12 scenes: after the first two, whose JAX programs (the
batch and its warp escalation) compile, a scene costs its two runs.
"""

import json
import os
import sys

import pytest
import torch

from keras_ocr_tpu.utils import golden as jgolden
from keras_ocr_tpu_torch.utils import golden

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_export import GOLDEN, _assert_same_reading  # noqa: E402

with open(os.path.join(GOLDEN, "expected.json"), encoding="utf8") as _f:
    ALL_SCENES = [entry["image"] for entry in json.load(_f)["scenes"]]

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def folded_pipelines():
    """The JAX pipeline with ``Detector(fold_bn=True)`` on the folded
    checkpoint, and the port's folded golden pipeline."""
    from keras_ocr_tpu.detection import Detector as JaxDetector
    from keras_ocr_tpu.models.craft import fold_bn_variables
    from keras_ocr_tpu.pipeline import Pipeline as JaxPipeline
    from keras_ocr_tpu.train.checkpoint import restore_npz

    jax_pipeline, _ = jgolden.load_golden_pipeline(GOLDEN)
    meta = golden._read_json(GOLDEN, golden.META_NAME)
    detector = JaxDetector(
        weights=None, width=meta["detector_width"], max_components=meta["max_components"],
        fold_bn=True,
    )
    detector.variables = fold_bn_variables(restore_npz(os.path.join(GOLDEN, golden.DETECTOR_NAME)))
    jax_folded = JaxPipeline(
        detector=detector, recognizer=jax_pipeline.recognizer, scale=meta["scale"],
        pad_to=tuple(meta["pad_to"]), max_words=meta["max_words"],
    )
    port_folded, _ = golden.load_golden_pipeline(GOLDEN, device="cpu", fold_bn=True)
    return jax_folded, port_folded


@pytest.mark.parametrize("scene", ALL_SCENES)
def test_folded_golden_scene_matches_jax_pipeline(folded_pipelines, scene):
    _assert_same_reading(*folded_pipelines, scene)
