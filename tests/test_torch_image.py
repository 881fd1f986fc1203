"""Port parity: image ops and host tools vs the JAX package.

``compute_input``, ``rgb_to_grayscale`` and ``pad`` must be exact on seeded
uint8 images; the 2x upscale and the general bilinear resize within 1e-5
(the JAX resize is a float32 matrix product, the port's two-tap gathers);
the PNG reader bit-exact with PIL.
"""

import glob
import os

import numpy as np
import PIL.Image
import pytest
import torch

import jax.numpy as jnp

from keras_ocr_tpu import tools as jtools
from keras_ocr_tpu.ops import image as jimage
from keras_ocr_tpu_torch import tools
from keras_ocr_tpu_torch.ops import image

torch.set_num_threads(2)

GOLDEN = os.path.join(os.path.dirname(__file__), "fixtures", "golden_offline")


def _uint8_batch(seed, shape=(2, 24, 40, 3)):
    return np.random.RandomState(seed).randint(0, 256, size=shape).astype(np.uint8)


@pytest.mark.parametrize("seed", [0, 1])
def test_compute_input_and_grayscale_exact(seed):
    batch = _uint8_batch(seed)
    ref = np.asarray(jimage.compute_input(jnp.asarray(batch)))
    out = image.compute_input(torch.from_numpy(batch)).numpy()
    np.testing.assert_array_equal(out, ref)
    ref = np.asarray(jimage.rgb_to_grayscale(jnp.asarray(batch.astype(np.float32))))
    out = image.rgb_to_grayscale(torch.from_numpy(batch)).numpy()
    np.testing.assert_array_equal(out, ref)


def test_grayscale_exact_on_all_channel_extremes():
    levels = np.array([0, 1, 127, 128, 254, 255], np.uint8)
    grid = np.stack(np.meshgrid(levels, levels, levels, indexing="ij"), -1).reshape(1, -1, 1, 3)
    ref = np.asarray(jimage.rgb_to_grayscale(jnp.asarray(grid.astype(np.float32))))
    out = image.rgb_to_grayscale(torch.from_numpy(grid)).numpy()
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("seed", [0, 1])
def test_upscale_and_resize_within_1e5(seed):
    batch = _uint8_batch(seed).astype(np.float32)
    ref = np.asarray(jimage._upscale2x(jnp.asarray(batch)))
    out = image._upscale2x(torch.from_numpy(batch)).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5 * 255)
    for height, width in ((48, 80), (37, 61), (13, 17), (50, 40)):
        ref = np.asarray(jimage.resize_bilinear(jnp.asarray(batch / 255.0), height, width))
        out = image.resize_bilinear(torch.from_numpy(batch / 255.0).float(), height, width).numpy()
        assert out.shape == ref.shape
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_pad_exact(seed):
    img = _uint8_batch(seed, (21, 33, 3))[...]
    for width, height, cval in ((40, 32, 255), (33, 21, 0), (64, 24, 7)):
        np.testing.assert_array_equal(
            tools.pad(img, width=width, height=height, cval=cval),
            jtools.pad(img, width=width, height=height, cval=cval),
        )
    with pytest.raises(ValueError):
        tools.pad(img, width=10, height=10)


def test_png_reader_matches_pil_on_golden_scenes():
    paths = sorted(glob.glob(os.path.join(GOLDEN, "scene_*.png")))
    assert len(paths) == 12
    for path in paths:
        np.testing.assert_array_equal(tools.read(path), jtools.read(path))


@pytest.mark.parametrize("mode", ["RGB", "RGBA"])
def test_png_reader_all_filter_types(tmp_path, mode):
    """PIL's optimising encoder picks all five scanline filters on this
    half-smooth, half-noise image."""
    rng = np.random.RandomState(3)
    channels = len(mode)
    img = rng.randint(0, 256, size=(40, 50, channels)).astype(np.uint8)
    img[:20] = (np.cumsum(img[:20], axis=1) // 8).astype(np.uint8)
    path = str(tmp_path / "x.png")
    PIL.Image.fromarray(img, mode).save(path, optimize=True)
    np.testing.assert_array_equal(tools.read(path), np.asarray(PIL.Image.open(path).convert("RGB")))
