"""Port parity: ``Detector.detect``, the host oracle ``getBoxes`` and the
geometry under it, vs the JAX package.

``polygon_area``, ``convex_hull`` and ``min_area_rect`` must equal JAX's
on seeded point sets (1e-4). ``getBoxes`` must find the same boxes as JAX
``getBoxes`` (scipy) within 1e-3 px. ``Detector.detect`` runs with its
CRAFT replaced by fixed heatmaps (JAX: ``_forward`` replaced) on one batch
that climbs all three ladders: a serpentine that needs 16 sweeps, more
components than the starting cap of 2, and split words that need the
refine pass. The boxes must equal JAX ``detect``'s within 1e-3 px, barring
counted bank-angle ties of equal area; with ``use_device_postprocess=False``
they must equal JAX's oracle. The oracle fallback warns and returns the
oracle's boxes.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from keras_ocr_tpu import detection as jdetection
from keras_ocr_tpu import tools as jtools
from keras_ocr_tpu_torch import detection, tools

sys.path.insert(0, os.path.dirname(__file__))
from test_postprocess import _synthetic_heatmap  # noqa: E402
from test_refine import _multiblob_heatmap  # noqa: E402
from test_torch_postprocess import _area  # noqa: E402

torch.set_num_threads(2)


def _point_sets():
    rng = np.random.RandomState(0)
    sets = [rng.randint(0, 40, size=(n, 2)).astype("float32") for n in (1, 2, 3, 7, 30, 200)]
    sets.append(rng.normal(size=(50, 2)) * [20.0, 3.0] + 50.0)
    sets.append(np.array([[0, 0], [4, 0], [8, 0]], "float32"))  # collinear
    angle = 0.3
    rot = np.array([[np.cos(angle), -np.sin(angle)], [np.sin(angle), np.cos(angle)]])
    sets.append((rng.rand(80, 2) * [30.0, 6.0]) @ rot.T)
    return sets


@pytest.mark.parametrize("case", range(9))
def test_geometry_matches_jax(case):
    points = _point_sets()[case]
    np.testing.assert_allclose(tools.convex_hull(points), jtools.convex_hull(points), atol=1e-4)
    assert tools.polygon_area(points) == pytest.approx(jtools.polygon_area(points), abs=1e-4)
    hull = jtools.convex_hull(points)
    assert tools.polygon_area(hull) == pytest.approx(jtools.polygon_area(hull), abs=1e-4)
    out, ref = tools.min_area_rect(points), jtools.min_area_rect(points)
    assert out.dtype == np.float32 and out.shape == (4, 2)
    np.testing.assert_allclose(out, ref, atol=1e-4)


def _compare(out, ref, ties):
    """Same count; boxes in the same order within 1e-3 px, or a bank tie."""
    assert len(out) == len(ref)
    for box, ref_box in zip(out, ref):
        if np.abs(box - ref_box).max() > 1e-3:
            assert _area(box) == pytest.approx(_area(ref_box), rel=1e-4)
            ties.append(box)


@pytest.mark.parametrize("seed", range(4))
def test_get_boxes_matches_jax_oracle(seed):
    rng = np.random.RandomState(seed)
    hm = np.stack([_synthetic_heatmap(rng), _multiblob_heatmap(rng, height=128, width=192)])
    kwargs = dict(detection_threshold=0.7, text_threshold=0.4, link_threshold=0.4,
                  size_threshold=10)
    out = detection.getBoxes(hm, **kwargs)
    ref = jdetection.getBoxes(hm, **kwargs)
    ties = []
    for image_out, image_ref in zip(out, ref):
        assert image_out.dtype == np.float32 and image_out.shape[1:] == (4, 2)
        _compare(image_out, image_ref, ties)
    assert not ties


def _snake(height=26, width=60):
    """A serpentine one component: 8 sweeps do not converge, 16 do."""
    fg = np.zeros((height, width), bool)
    for i, row in enumerate(range(1, height - 1, 2)):
        fg[row, 2 : width - 2] = True
        if row + 2 < height - 1:
            fg[row + 1, width - 3 if i % 2 == 0 else 2] = True
    return fg


def _ladder_batch():
    """(3, 96, 128, 2): the serpentine, three words, two split words."""
    snake = np.zeros((96, 128, 2), "float32")
    snake[30:56, 30:90, 0] = np.where(_snake(), 0.95, 0.0)
    words = np.zeros((96, 128, 2), "float32")
    for y, x in ((10, 10), (40, 60), (70, 20)):
        words[y : y + 8, x : x + 30, 0] = 0.9
    split = _multiblob_heatmap(np.random.RandomState(5), n_words=2)
    return np.stack([snake, words, split])


class _FixedCraft(torch.nn.Module):
    def __init__(self, heatmaps):
        super().__init__()
        self.heatmaps = torch.from_numpy(heatmaps)

    def forward(self, x):
        assert x.shape[0] == self.heatmaps.shape[0] and x.dtype == torch.float32
        return self.heatmaps


@pytest.fixture(scope="module")
def ladder_detectors():
    hm = _ladder_batch()
    jax_detector = jdetection.Detector(weights=None, width=0.25, max_components=2)
    jax_detector._forward = lambda variables, x: jnp.asarray(hm)
    port = detection.Detector(width=0.25, max_components=2, device="cpu")
    port.model = _FixedCraft(hm)
    images = [np.zeros((192, 256, 3), np.uint8)] * 3
    return jax_detector, port, images, hm


def test_detect_climbs_the_ladders_like_jax(ladder_detectors, monkeypatch):
    from keras_ocr_tpu_torch.ops import postprocess, refine

    jax_detector, port, images, hm = ladder_detectors
    calls = []

    def counted(fn, name):
        def wrapper(*args, **kwargs):
            calls.append((name, kwargs.get("max_components"), kwargs.get("num_sweeps")))
            return fn(*args, **kwargs)
        return wrapper

    monkeypatch.setattr(postprocess, "get_boxes", counted(postprocess.get_boxes, "get_boxes"))
    monkeypatch.setattr(refine, "refine_boxes", counted(refine.refine_boxes, "refine"))
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("error")  # no oracle fallback, no cap warning
        out = port.detect(images)
    assert calls == [("get_boxes", 2, 8), ("get_boxes", 2, 16), ("get_boxes", 4, 16),
                     ("refine", 4, 16)]
    ref = jax_detector.detect(images)
    ties = []
    for image_out, image_ref in zip(out, ref):
        _compare(image_out, image_ref, ties)
    assert len(ties) <= 1
    assert [len(b) for b in out] == [1, 3, 2]


def test_detect_on_the_host_matches_jax(ladder_detectors):
    jax_detector, port, images, _ = ladder_detectors
    out = port.detect(images, use_device_postprocess=False)
    ref = jax_detector.detect(images, use_device_postprocess=False)
    ties = []
    for image_out, image_ref in zip(out, ref):
        _compare(image_out, image_ref, ties)
    assert not ties


def test_detect_falls_back_on_the_oracle(ladder_detectors, monkeypatch):
    """With the sweep ceiling at the start, the serpentine cannot be proven
    converged on the device: that image alone takes the oracle, with a
    warning."""
    _, port, images, hm = ladder_detectors
    monkeypatch.setattr(detection, "MAX_SWEEPS_CEILING", 8)
    with pytest.warns(UserWarning, match="falling back to host post-processing for them"):
        out = port.detect(images)
    host = detection.getBoxes(hm[:1])[0]
    np.testing.assert_array_equal(out[0], host)
    assert [len(b) for b in out] == [1, 3, 2]
