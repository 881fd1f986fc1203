"""Port parity for the pipeline's newer paths: the non-uniform resize and
the contours[0] refine ladder, against the JAX ``Pipeline``.

Kept apart from ``test_torch_pipeline.py`` so that the two files, each
with its own JAX compiles, run side by side. The golden artifact's slim
models serve both; for the refine ladder both CRAFTs are replaced by
fixed multi-blob heatmaps, since neither the artifact nor random weights
ever raise the multi-blob flag.
"""

import os
import sys
import warnings

import numpy as np
import pytest
import torch

from keras_ocr_tpu import evaluation
from keras_ocr_tpu.utils import golden as jgolden
from keras_ocr_tpu_torch.utils import golden

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "fixtures", "golden_offline")
SCENES = ["scene_00.png", "scene_01.png"]


@pytest.fixture(scope="module")
def pipelines():
    jax_pipeline, _ = jgolden.load_golden_pipeline(GOLDEN)
    port_pipeline, _ = golden.load_golden_pipeline(GOLDEN, device="cpu")
    return jax_pipeline, port_pipeline


def test_non_uniform_scale_matches_jax_pipeline(pipelines):
    """Scenes whose longest side x scale passes ``max_size`` are resized on
    the host and padded in resized space, as in JAX: scales 1.0 and 1.0667
    in one batch."""
    from keras_ocr_tpu import tools as jtools
    from keras_ocr_tpu.pipeline import Pipeline as JaxPipeline
    from keras_ocr_tpu_torch import Pipeline

    jax_golden, port_golden = pipelines
    jax_pipeline = JaxPipeline(
        detector=jax_golden.detector, recognizer=jax_golden.recognizer, scale=2, max_size=320,
        max_words=jax_golden.max_words,
    )
    port_pipeline = Pipeline(
        detector=port_golden.detector, recognizer=port_golden.recognizer, scale=2, max_size=320,
        max_words=port_golden.max_words,
    )
    images = [jtools.read(os.path.join(GOLDEN, scene)) for scene in SCENES]
    images[1] = images[1][:200, :300]  # mixed sizes in one batch
    ref = jax_pipeline.recognize(images)
    out = port_pipeline.recognize(images)
    assert [[w for w, _ in r] for r in out] == [[w for w, _ in r] for r in ref]
    assert any(r for r in out)
    for got, want in zip(out, ref):
        for (_, box), (_, ref_box) in zip(got, want):
            assert evaluation.iou_score(box, ref_box) > 0.9
    assert port_pipeline.last_run_stats == {
        k: jax_pipeline.last_run_stats[k] for k in port_pipeline.last_run_stats
    }


class _FixedCraft(torch.nn.Module):
    """A CRAFT stand-in returning fixed (H/2, W/2, 2) heatmaps."""

    def __init__(self, heatmaps):
        super().__init__()
        self.heatmaps = torch.from_numpy(heatmaps)

    def forward(self, x):
        return self.heatmaps[None].expand((x.shape[0],) + self.heatmaps.shape)


def test_refine_ladder_matches_jax_pipeline(pipelines):
    """Both CRAFTs replaced by fixed multi-blob heatmaps (the JAX stand-in
    set before the first call, since its jit reads the model when it
    traces): the refine ladder escalates alike and the words and boxes are
    equal."""
    import jax.numpy as jnp

    from keras_ocr_tpu.detection import Detector as JaxDetector
    from keras_ocr_tpu.pipeline import Pipeline as JaxPipeline
    from keras_ocr_tpu_torch import Detector, Pipeline

    sys.path.insert(0, os.path.dirname(__file__))
    from test_refine import _multiblob_heatmap

    hm = _multiblob_heatmap(np.random.RandomState(5), n_words=2)

    class FakeCraft:
        def apply(self, variables, x, train=False):
            return jnp.broadcast_to(jnp.asarray(hm)[None], (x.shape[0],) + hm.shape)

    jax_golden, port_golden = pipelines
    jax_detector = JaxDetector(weights=None, width=0.25, max_components=16)
    jax_detector.model = FakeCraft()
    detector = Detector(weights=None, width=0.25, max_components=16, device="cpu")
    detector.model = _FixedCraft(hm)
    size = (hm.shape[0] * 2, hm.shape[1] * 2)
    kwargs = dict(scale=1, max_words=8, pad_to=size)
    jax_pipeline = JaxPipeline(detector=jax_detector, recognizer=jax_golden.recognizer, **kwargs)
    port_pipeline = Pipeline(detector=detector, recognizer=port_golden.recognizer, **kwargs)
    image = np.zeros(size + (3,), np.uint8)
    ref = jax_pipeline.recognize([image])[0]
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # no refine warning: flag 2 ends clear
        out = port_pipeline.recognize([image])[0]
    assert port_pipeline.last_run_stats["refine_escalations"] >= 1
    assert port_pipeline.last_run_stats == {
        k: jax_pipeline.last_run_stats[k] for k in port_pipeline.last_run_stats
    }
    assert len(out) >= 2
    assert [w for w, _ in out] == [w for w, _ in ref]
    for (_, box), (_, ref_box) in zip(out, ref):
        np.testing.assert_allclose(box, ref_box, atol=1e-3)
