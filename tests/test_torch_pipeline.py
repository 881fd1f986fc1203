"""Port parity for the whole slice: the golden pipeline in both packages.

The committed golden artifact (trained slim CRAFT + CRNN) runs through the
JAX ``Pipeline`` and the port's ``Pipeline`` on the same scenes: the words
must be equal, every box matched at IoU > 0.9, and the escalation ladders
must take the same steps. Random weights are not used here: their heatmaps
sit on threshold knife edges. The BN-folded detector's scenes:
``tests/test_torch_pipeline_folded.py``; the port's own golden check,
``recognize_many``, the entry points and the run with JAX blocked:
``tests/test_torch_pipeline_entry.py`` (files of their own, so that the
test workers share the JAX compiles out).
"""

import os

import numpy as np
import pytest
import torch

from keras_ocr_tpu import evaluation
from keras_ocr_tpu.utils import golden as jgolden
from keras_ocr_tpu_torch.utils import golden

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "fixtures", "golden_offline")
SCENES = ["scene_00.png", "scene_01.png", "scene_02.png", "scene_03.png"]


@pytest.fixture(scope="module")
def pipelines():
    jax_pipeline, _ = jgolden.load_golden_pipeline(GOLDEN)
    port_pipeline, _ = golden.load_golden_pipeline(GOLDEN, device="cpu")
    return jax_pipeline, port_pipeline


def _assert_same_reading(jax_pipeline, port_pipeline, scene):
    from keras_ocr_tpu import tools as jtools

    image = jtools.read(os.path.join(GOLDEN, scene))
    ref = jax_pipeline.recognize([image])[0]
    out = port_pipeline.recognize([image])[0]
    assert [word for word, _ in out] == [word for word, _ in ref]
    for (_, box), (_, ref_box) in zip(out, ref):
        assert box.shape == (4, 2) and box.dtype == np.float32
        assert evaluation.iou_score(box, ref_box) > 0.9
    common = set(jax_pipeline.last_run_stats) & set(port_pipeline.last_run_stats)
    assert {k: port_pipeline.last_run_stats[k] for k in common} == {
        k: jax_pipeline.last_run_stats[k] for k in common
    }


@pytest.mark.parametrize("scene", SCENES)
def test_golden_scene_matches_jax_pipeline(pipelines, scene):
    _assert_same_reading(*pipelines, scene)
