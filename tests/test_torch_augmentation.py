"""Port parity: ``data/augmentation.py`` and ``tools.augment`` vs the JAX package.

Every augmenter and ``Sequential`` is built from one seed in both packages;
three frozen draws (``to_deterministic``) of each are applied to the same
seeded uint8 images (RGB and grey) and keypoints. Both packages compute with
numpy and scipy in the same order, so the images must be equal bit for bit
and the keypoints within 1e-9. ``tools.augment`` must keep the same boxes in
each box format, with coordinates within 1e-9, including boxes cropped out
of the canvas, the ``area_threshold`` rule, ``min_area`` and a call given
only ``image_shape``.
"""

import numpy as np
import pytest
import torch

from keras_ocr_tpu import tools as jtools
from keras_ocr_tpu.data import augmentation as jaug
from keras_ocr_tpu_torch import tools
from keras_ocr_tpu_torch.data import augmentation as taug

torch.set_num_threads(2)

KEYPOINT_BAR = 1e-9

AUGMENTERS = {
    "affine": lambda a: a.Affine(rotate=(-30, 30), scale=(0.8, 1.2), shear=(-10, 10), cval=17,
                                 translate_percent={"x": (-0.1, 0.1), "y": (-0.05, 0.05)}),
    "affine_fixed": lambda a: a.Affine(rotate=12, scale=1.1, translate_percent=0.05),
    "affine_translate_range": lambda a: a.Affine(translate_percent=(-0.2, 0.2)),
    "crop_px": lambda a: a.Crop(px=((0, 10),) * 4),
    "crop_px_sides": lambda a: a.Crop(px=((0, 3), 5, (1, 8), 0)),
    "crop_percent": lambda a: a.Crop(percent=((0, 0.2),) * 4),
    "crop_to_fixed_uniform": lambda a: a.CropToFixedSize(width=20, height=15),
    "crop_to_fixed_right_bottom": lambda a: a.CropToFixedSize(20, 15, position="right-bottom"),
    "crop_to_fixed_left_top": lambda a: a.CropToFixedSize(20, 15, position="left-top"),
    "crop_to_fixed_center": lambda a: a.CropToFixedSize(50, 40, position="center"),
    "gaussian_blur": lambda a: a.GaussianBlur(sigma=(0, 2)),
    "gaussian_blur_fixed": lambda a: a.GaussianBlur(sigma=0.7),
    "multiply": lambda a: a.Multiply(mul=(0.5, 1.5)),
    "gamma_contrast": lambda a: a.GammaContrast(gamma=(0.5, 2.0)),
    "invert": lambda a: a.Invert(p=0.5),
    "invert_per_channel": lambda a: a.Invert(p=0.5, per_channel=True),
    "invert_per_channel_p": lambda a: a.Invert(p=0.7, per_channel=0.5),
    "resize": lambda a: a.Resize((20, 30)),
    "sequential": lambda a: a.Sequential([
        a.Affine(rotate=(-10, 10), scale=(0.9, 1.1)), a.GaussianBlur((0, 0.5)),
        a.Multiply((0.9, 1.1)), a.Crop(px=((0, 4),) * 4), a.GammaContrast((0.8, 1.2)),
        a.Invert(p=0.3), a.CropToFixedSize(30, 25), a.Resize((24, 36))]),
}


def _image(shape, seed):
    return np.random.RandomState(seed).randint(0, 256, size=shape).astype(np.uint8)


def _keypoints(seed, height=33, width=47):
    rng = np.random.RandomState(seed)
    return np.stack([rng.uniform(-5, width + 5, 12), rng.uniform(-5, height + 5, 12)], 1)


@pytest.mark.parametrize("name", list(AUGMENTERS))
def test_augmenter_matches_jax(name):
    ours, theirs = AUGMENTERS[name](taug), AUGMENTERS[name](jaug)
    ours._rng, theirs._rng = np.random.RandomState(3), np.random.RandomState(3)
    xy = _keypoints(1)
    for draw in range(3):
        frozen_ours, frozen_theirs = ours.to_deterministic(), theirs.to_deterministic()
        for shape in ((33, 47, 3), (33, 47)):
            image = _image(shape, draw)
            out, ref = frozen_ours.apply_image(image), frozen_theirs.apply_image(image)
            assert out.dtype == ref.dtype == np.uint8
            np.testing.assert_array_equal(out, ref)
            assert frozen_ours.output_shape(shape) == frozen_theirs.output_shape(shape)
            got = frozen_ours.augment_keypoints(xy, shape)
            want = frozen_theirs.augment_keypoints(xy, shape)
            assert got.dtype == want.dtype
            np.testing.assert_allclose(got, want, rtol=0, atol=KEYPOINT_BAR)
    # The unfrozen entry points draw from the same stream.
    images = [_image((33, 47, 3), seed) for seed in (7, 8)]
    for got, want in zip(ours.augment_images(images), theirs.augment_images(images)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(ours(images=images), theirs(images=images)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ours.augment_image(images[0]), theirs.augment_image(images[0]))


def _boxes(seed, height=60, width=80):
    """Quads inside, straddling and outside a height x width canvas, one of
    them degenerate (zero area)."""
    rng = np.random.RandomState(seed)
    boxes = []
    for _ in range(10):
        x, y = rng.uniform(-20, width + 10), rng.uniform(-20, height + 10)
        w, h = rng.uniform(4, 30), rng.uniform(4, 15)
        boxes.append(np.array([[x, y], [x + w, y], [x + w, y + h], [x, y + h]], "float32"))
    boxes.append(np.array([[5, 5], [5, 5], [5, 5], [5, 5]], "float32"))
    return boxes


AUGMENT_CASES = {
    "affine_crop": (lambda a: a.Sequential([a.Affine(rotate=(-20, 20), scale=(0.8, 1.3)),
                                            a.Crop(px=((0, 12),) * 4)]), dict()),
    "threshold_0.9": (lambda a: a.Sequential([a.Affine(rotate=(-20, 20)),
                                              a.Crop(px=((0, 12),) * 4)]),
                      dict(area_threshold=0.9)),
    "min_area": (lambda a: a.Affine(scale=(0.7, 1.4), translate_percent=(-0.2, 0.2)),
                 dict(area_threshold=0.2, min_area=60)),
    "focused_crop": (lambda a: a.Sequential([a.Crop(px=(5, 0, 0, 9)),
                                             a.CropToFixedSize(40, 30, position="right-bottom")]),
                     dict()),
}


@pytest.mark.parametrize("boxes_format", ["boxes", "lines", "predictions"])
@pytest.mark.parametrize("case", list(AUGMENT_CASES))
def test_tools_augment_matches_jax(case, boxes_format):
    make, kwargs = AUGMENT_CASES[case]
    boxes = _boxes(len(case))
    if boxes_format == "lines":
        boxes = [list(zip(boxes[:4], "abcd")), list(zip(boxes[4:], "efghijk"))]
    elif boxes_format == "predictions":
        boxes = [(f"w{i}", box) for i, box in enumerate(boxes)]
    image = _image((60, 80, 3), 5)
    for with_image in (True, False):
        ours, theirs = make(taug), make(jaug)
        ours._rng, theirs._rng = np.random.RandomState(11), np.random.RandomState(11)
        for _ in range(3):
            source = dict(image=image) if with_image else dict(image_shape=image.shape[:2])
            got_image, got = tools.augment(boxes, ours, boxes_format=boxes_format, **source,
                                           **kwargs)
            want_image, want = jtools.augment(boxes, theirs, boxes_format=boxes_format,
                                              **source, **kwargs)
            if with_image:
                np.testing.assert_array_equal(got_image, want_image)
            else:
                assert got_image is None and want_image is None
            if boxes_format == "lines":
                assert [len(line) for line in got] == [len(line) for line in want]
                got = [(c, box) for line in got for box, c in line]
                want = [(c, box) for line in want for box, c in line]
            elif boxes_format == "boxes":
                got, want = [(None, box) for box in got], [(None, box) for box in want]
            assert len(got) == len(want)
            for (label, box), (want_label, want_box) in zip(got, want):
                assert label == want_label
                np.testing.assert_allclose(box, want_box, rtol=0, atol=KEYPOINT_BAR)


def test_tools_augment_drops_boxes_cropped_out():
    """A crop that removes the left 30 columns drops the box inside them,
    keeps the one past them, and clips the one across them (kept at the
    default threshold 0.5 when most of it stays)."""
    boxes = [np.array([[2, 2], [20, 2], [20, 10], [2, 10]], "float32"),
             np.array([[40, 2], [60, 2], [60, 10], [40, 10]], "float32"),
             np.array([[25, 20], [55, 20], [55, 30], [25, 30]], "float32")]
    image = _image((40, 80, 3), 2)
    crop = taug.Crop(px=(0, 0, 0, 30))
    out, kept = tools.augment(boxes, crop, image=image)
    assert out.shape == (40, 50, 3)
    assert len(kept) == 2
    np.testing.assert_array_equal(kept[0], [[10, 2], [30, 2], [30, 10], [10, 10]])
    np.testing.assert_array_equal(kept[1], [[0, 20], [25, 20], [25, 30], [0, 30]])
    with pytest.raises(ValueError):
        tools.augment(boxes, crop)
