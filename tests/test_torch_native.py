"""The port's host-ops library (``keras_ocr_tpu_torch/native.py`` over
``keras_ocr_tpu_torch/csrc/hostops.cpp``) against its numpy paths and the
JAX package's library, bit for bit: the bilinear resize and the
perspective warp against the numpy versions beside them
(``resize_bilinear_plain``, ``warp_perspective_plain``), the labelling
against the oracle's plain labelling (``detection._label_components``)
and scipy, the dilation against ``detection._dilate_cv2_style``; and
``Detector.detect``'s host oracle with the library and with it disabled.
"""

import os
import sys

import numpy as np
import pytest
import torch
from scipy import ndimage

from keras_ocr_tpu import native as jnative
from keras_ocr_tpu_torch import detection, native, tools

sys.path.insert(0, os.path.dirname(__file__))
from test_postprocess import _synthetic_heatmap  # noqa: E402
from test_refine import _multiblob_heatmap  # noqa: E402

torch.set_num_threads(2)

FOUR_CONNECTED = [[0, 1, 0], [1, 1, 1], [0, 1, 0]]
# (source shape, target height and width): odd sizes, up and down, one pixel.
RESIZES = [((37, 53, 3), (80, 120)), ((40, 60), (13, 7)), ((1, 1, 3), (5, 4)),
           ((17, 9, 1), (17, 9)), ((31, 200), (62, 400)), ((64, 96, 3), (1, 1))]
# (density, height, width): empty and full masks, odd sizes, single rows and columns.
MASKS = [(0.0, 31, 47), (1.0, 31, 47), (0.3, 1, 57), (0.5, 43, 1), (0.6, 33, 65),
         (0.85, 50, 80)]


@pytest.fixture(scope="module", autouse=True)
def libraries():
    assert native.available(), "the host compiler builds csrc/hostops.cpp here"
    if not jnative.available():
        pytest.skip("the JAX package's host-ops library does not build here")


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("case", range(len(RESIZES)))
def test_resize_bilinear_is_exact(case, dtype):
    shape, (height, width) = RESIZES[case]
    rng = np.random.RandomState(case)
    image = rng.randint(0, 256, shape).astype(dtype)
    if dtype == "float32":
        image = image * np.float32(1.37) - np.float32(9.5)
    out = native.resize_bilinear(image, height, width)
    assert out.dtype == image.dtype and out.shape == (height, width) + shape[2:]
    np.testing.assert_array_equal(out, native.resize_bilinear_plain(image, height, width))
    np.testing.assert_array_equal(out, jnative.resize_bilinear(image, height, width))


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("seed", range(3))
def test_warp_perspective_is_exact(seed, dtype):
    """A word box to a 64x32 crop, and the inverse map onto a canvas larger
    than the source (taps outside take ``cval``)."""
    rng = np.random.RandomState(seed)
    image = rng.randint(0, 256, (51, 71, 3) if seed != 1 else (51, 71)).astype(dtype)
    src = np.array([[5, 5], [60, 8], [58, 40], [4, 38]], np.float32)
    src += rng.randn(4, 2).astype(np.float32) * 3
    dst = np.array([[0, 0], [64, 0], [64, 32], [0, 32]], np.float32)
    M = tools.get_perspective_transform(src, dst)
    for matrix, dsize, cval in ((M, (64, 32), 0.0), (np.linalg.inv(M), (93, 67), 7.0)):
        out = native.warp_perspective(image, matrix, dsize, cval)
        assert out.dtype == image.dtype and out.shape[:2] == dsize[::-1]
        np.testing.assert_array_equal(out, native.warp_perspective_plain(image, matrix, dsize,
                                                                          cval))
        np.testing.assert_array_equal(out, jnative.warp_perspective(image, matrix, dsize, cval))


def _mask(case):
    density, height, width = MASKS[case]
    return np.random.RandomState(case).rand(height, width) < density


@pytest.mark.parametrize("case", range(len(MASKS)))
def test_label_components_is_exact(case):
    mask = _mask(case)
    labels, count = native.label_components(mask)
    assert labels.dtype == np.int32
    plain, plain_count = detection._label_components(mask)
    expected, scipy_count = ndimage.label(mask, structure=FOUR_CONNECTED)
    jax_labels, jax_count = jnative.label_components(mask)
    assert count == plain_count == scipy_count == jax_count
    for other in (plain, expected, jax_labels):
        np.testing.assert_array_equal(labels, other)


@pytest.mark.parametrize("niter", range(6))
def test_dilate_square_is_exact(niter):
    for case in range(len(MASKS)):
        mask = _mask(case) & (np.random.RandomState(9).rand(*_mask(case).shape) < 0.2)
        out = native.dilate_square(mask, niter)
        assert out.dtype == bool
        np.testing.assert_array_equal(out, detection._dilate_cv2_style(mask, niter))
        np.testing.assert_array_equal(out, jnative.dilate_square(mask, niter))


class _FixedCraft(torch.nn.Module):
    def __init__(self, heatmaps):
        super().__init__()
        self.heatmaps = torch.from_numpy(heatmaps)

    def forward(self, x):
        return self.heatmaps


@pytest.mark.parametrize("seed", range(2))
def test_detect_oracle_is_the_same_without_the_library(seed, monkeypatch):
    """``Detector.detect(use_device_postprocess=False)`` on word and
    split-word heatmaps: the library's calls counted, the boxes identical
    with it and with it disabled."""
    rng = np.random.RandomState(seed)
    hm = np.stack([_synthetic_heatmap(rng), _multiblob_heatmap(rng, height=128, width=192)])
    detector = detection.Detector(weights=None, width=0.125, device="cpu")
    detector.model = _FixedCraft(hm)
    images = [np.zeros((256, 384, 3), np.uint8)] * 2
    before = native.calls
    with_library = detector.detect(images, use_device_postprocess=False)
    assert native.calls > before
    monkeypatch.setattr(native, "available", lambda: False)
    calls = native.calls
    without = detector.detect(images, use_device_postprocess=False)
    assert native.calls == calls
    assert [len(b) for b in with_library] == [len(b) for b in without] and len(without[0])
    for got, want in zip(with_library, without):
        np.testing.assert_array_equal(got, want)


def test_a_failed_build_warns_and_reports_unavailable(tmp_path, monkeypatch):
    """A compiler that fails: ``available()`` is False, with a warning
    naming the error, and a call raises."""
    monkeypatch.setattr(native.kernels, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "_state", {})
    monkeypatch.setenv("CXX", "false")
    with pytest.warns(RuntimeWarning, match="host compiler failed"):
        assert not native.available()
    assert not native.available()  # decided once
    with pytest.raises(RuntimeError, match="unavailable"):
        native.label_components(np.ones((2, 2), bool))
    assert not os.listdir(tmp_path)
