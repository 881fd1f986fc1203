"""Joint image and keypoint augmentation (the imgaug subset keras-ocr uses).

The port's copy of ``keras_ocr_tpu/data/augmentation.py``: ``Affine``,
``GaussianBlur``, ``Multiply``, ``GammaContrast``, ``Invert``, ``Crop``,
``CropToFixedSize``, ``Resize`` and ``Sequential`` as numpy and scipy
transforms with explicit keypoint propagation and imgaug's
``to_deterministic()`` contract (sample the parameters once, then apply the
frozen transform to the image and to its keypoints). Host code, as in the
JAX package; it draws from ``np.random.RandomState(seed)`` in the same
order, so one seed gives the same images in both packages. ``Affine`` warps
through :func:`keras_ocr_tpu_torch.tools.warp_perspective` and ``Resize``
through ``tools._resize``.
"""

from __future__ import annotations

import typing

import numpy as np
from scipy import ndimage as _ndimage

from .. import tools


def _interval(value, rng, integer=False):
    """Sample from a scalar / (lo, hi) tuple spec."""
    if isinstance(value, (tuple, list)):
        lo, hi = value
        if integer:
            return int(rng.randint(lo, hi + 1))
        return float(rng.uniform(lo, hi))
    return value


class Augmenter:
    """Base augmenter. Subclasses implement ``_sample`` returning a frozen
    (deterministic) instance, plus ``apply_image`` / ``apply_keypoints``."""

    def __init__(self, seed: typing.Optional[int] = None):
        self._rng = np.random.RandomState(seed)

    # -- sampling ----------------------------------------------------------

    def to_deterministic(self) -> "Augmenter":
        return self._sample(self._rng)

    def _sample(self, rng) -> "Augmenter":
        return self

    # -- application -------------------------------------------------------

    def __call__(self, image=None, images=None):
        if images is not None:
            frozen = self
            return [frozen.to_deterministic().apply_image(im) for im in images]
        return self.apply_image(image)

    def augment_image(self, image):
        return self.to_deterministic().apply_image(image)

    def augment_images(self, images):
        return [self.augment_image(image) for image in images]

    def apply_image(self, image):
        return image

    def augment_keypoints(self, xy: np.ndarray, image_shape) -> np.ndarray:
        return self.apply_keypoints(np.asarray(xy, dtype="float32"), image_shape)

    def apply_keypoints(self, xy: np.ndarray, image_shape) -> np.ndarray:
        return xy

    def output_shape(self, image_shape):
        return image_shape


class Sequential(Augmenter):
    def __init__(self, children: typing.List[Augmenter], seed=None):
        super().__init__(seed)
        self.children = list(children)

    def _sample(self, rng):
        return Sequential([child._sample(rng) for child in self.children])

    def apply_image(self, image):
        for child in self.children:
            image = child.apply_image(image)
        return image

    def apply_keypoints(self, xy, image_shape):
        for child in self.children:
            xy = child.apply_keypoints(xy, image_shape)
            image_shape = child.output_shape(image_shape)
        return xy

    def output_shape(self, image_shape):
        for child in self.children:
            image_shape = child.output_shape(image_shape)
        return image_shape


class Affine(Augmenter):
    """Rotation/scale/translation/shear about the image center."""

    def __init__(self, rotate=0, scale=1.0, translate_percent=None, shear=0, cval=0, seed=None):
        super().__init__(seed)
        self.rotate = rotate
        self.scale = scale
        self.translate_percent = translate_percent
        self.shear = shear
        self.cval = cval

    def _sample(self, rng):
        frozen = Affine(
            rotate=_interval(self.rotate, rng),
            scale=_interval(self.scale, rng),
            translate_percent={
                "x": _interval((self.translate_percent or {}).get("x", 0), rng),
                "y": _interval((self.translate_percent or {}).get("y", 0), rng),
            }
            if isinstance(self.translate_percent, dict)
            else {"x": _interval(self.translate_percent or 0, rng), "y": 0},
            shear=_interval(self.shear, rng),
            cval=self.cval,
        )
        return frozen

    def _matrix(self, image_shape):
        height, width = image_shape[:2]
        theta = np.deg2rad(self.rotate)
        shear = np.deg2rad(self.shear)
        scale = self.scale
        tx = self.translate_percent["x"] * width
        ty = self.translate_percent["y"] * height
        center = np.array(
            [[1, 0, width / 2], [0, 1, height / 2], [0, 0, 1]], dtype="float64"
        )
        transform = np.array(
            [
                [scale * np.cos(theta), -scale * np.sin(theta + shear), tx],
                [scale * np.sin(theta), scale * np.cos(theta + shear), ty],
                [0, 0, 1],
            ]
        )
        uncenter = np.array(
            [[1, 0, -width / 2], [0, 1, -height / 2], [0, 0, 1]], dtype="float64"
        )
        return center @ transform @ uncenter

    def apply_image(self, image):
        M = self._matrix(image.shape)
        return tools.warp_perspective(
            image, M, dsize=(image.shape[1], image.shape[0]), cval=self.cval
        )

    def apply_keypoints(self, xy, image_shape):
        M = self._matrix(image_shape)
        homog = np.concatenate([xy, np.ones((len(xy), 1))], axis=1)
        mapped = (M @ homog.T).T
        return (mapped[:, :2] / mapped[:, 2:]).astype("float32")


class Crop(Augmenter):
    """Crop pixels from the (top, right, bottom, left) borders."""

    def __init__(self, px=(0, 0, 0, 0), percent=None, seed=None):
        super().__init__(seed)
        self.px = px
        self.percent = percent

    def _sample(self, rng):
        if self.percent is not None:
            return _FrozenCrop(percent=tuple(
                _interval(p, rng) for p in self._expand(self.percent)
            ))
        return _FrozenCrop(px=tuple(
            _interval(p, rng, integer=True) for p in self._expand(self.px)
        ))

    @staticmethod
    def _expand(spec):
        if isinstance(spec, (int, float)):
            return (spec,) * 4
        return tuple(spec)


class _FrozenCrop(Augmenter):
    def __init__(self, px=None, percent=None):
        super().__init__()
        self.px = px
        self.percent = percent

    def _amounts(self, image_shape):
        height, width = image_shape[:2]
        if self.percent is not None:
            top, right, bottom, left = self.percent
            return (
                int(round(top * height)),
                int(round(right * width)),
                int(round(bottom * height)),
                int(round(left * width)),
            )
        return self.px

    def apply_image(self, image):
        top, right, bottom, left = self._amounts(image.shape)
        height, width = image.shape[:2]
        return image[top : height - bottom or None, left : width - right or None]

    def apply_keypoints(self, xy, image_shape):
        top, _, _, left = self._amounts(image_shape)
        return xy - np.array([left, top], dtype="float32")

    def output_shape(self, image_shape):
        top, right, bottom, left = self._amounts(image_shape)
        return (image_shape[0] - top - bottom, image_shape[1] - left - right) + tuple(
            image_shape[2:]
        )


class CropToFixedSize(Augmenter):
    """Crop to an exact size.

    ``position="right-bottom"`` removes pixels from the right/bottom sides
    (keeping the top-left region) — the semantics the reference's focused
    detector crops rely on (datasets.py:402-416: the text box was just
    shifted to the origin, so the kept region must contain the origin).
    """

    def __init__(self, width, height, position="uniform", seed=None):
        super().__init__(seed)
        self.width = width
        self.height = height
        self.position = position

    def _sample(self, rng):
        frozen = CropToFixedSize(self.width, self.height, self.position)
        frozen._fractions = (
            (rng.uniform(), rng.uniform())
            if self.position == "uniform"
            else {"right-bottom": (0.0, 0.0), "left-top": (1.0, 1.0), "center": (0.5, 0.5)}[
                self.position
            ]
        )
        return frozen

    def _offsets(self, image_shape):
        height, width = image_shape[:2]
        fx, fy = getattr(self, "_fractions", (0.0, 0.0))
        left = int(round(fx * max(width - self.width, 0)))
        top = int(round(fy * max(height - self.height, 0)))
        return top, left

    def apply_image(self, image):
        top, left = self._offsets(image.shape)
        return image[top : top + self.height, left : left + self.width]

    def apply_keypoints(self, xy, image_shape):
        top, left = self._offsets(image_shape)
        return xy - np.array([left, top], dtype="float32")

    def output_shape(self, image_shape):
        return (
            min(self.height, image_shape[0]),
            min(self.width, image_shape[1]),
        ) + tuple(image_shape[2:])


class GaussianBlur(Augmenter):
    def __init__(self, sigma=(0.0, 1.0), seed=None):
        super().__init__(seed)
        self.sigma = sigma

    def _sample(self, rng):
        return GaussianBlur(sigma=_interval(self.sigma, rng))

    def apply_image(self, image):
        sigma = self.sigma
        if sigma <= 0:
            return image
        blurred = np.stack(
            [
                _ndimage.gaussian_filter(image[..., c].astype("float32"), sigma)
                for c in range(image.shape[-1])
            ],
            axis=-1,
        ) if image.ndim == 3 else _ndimage.gaussian_filter(image.astype("float32"), sigma)
        return np.clip(blurred, 0, 255).astype(image.dtype)


class Multiply(Augmenter):
    def __init__(self, mul=(0.8, 1.2), seed=None):
        super().__init__(seed)
        self.mul = mul

    def _sample(self, rng):
        return Multiply(mul=_interval(self.mul, rng))

    def apply_image(self, image):
        return np.clip(image.astype("float32") * self.mul, 0, 255).astype(image.dtype)


class GammaContrast(Augmenter):
    def __init__(self, gamma=(0.5, 2.0), seed=None):
        super().__init__(seed)
        self.gamma = gamma

    def _sample(self, rng):
        return GammaContrast(gamma=_interval(self.gamma, rng))

    def apply_image(self, image):
        scaled = np.clip(image.astype("float32") / 255.0, 0, 1)
        return np.clip((scaled**self.gamma) * 255.0, 0, 255).astype(image.dtype)


class Invert(Augmenter):
    def __init__(self, p=0.5, per_channel=False, seed=None):
        super().__init__(seed)
        self.p = p
        self.per_channel = per_channel

    def _sample(self, rng):
        frozen = Invert(p=self.p, per_channel=self.per_channel)
        if isinstance(self.per_channel, float):
            per_channel = rng.uniform() < self.per_channel
        else:
            per_channel = self.per_channel
        if per_channel:
            frozen._invert = rng.uniform(size=3) < self.p
        else:
            frozen._invert = np.repeat(rng.uniform() < self.p, 3)
        return frozen

    def apply_image(self, image):
        invert = getattr(self, "_invert", np.zeros(3, bool))
        if image.ndim == 2:
            return (255 - image) if invert[0] else image
        out = image.copy()
        for c in range(min(image.shape[-1], 3)):
            if invert[c]:
                out[..., c] = 255 - out[..., c]
        return out


class Resize(Augmenter):
    def __init__(self, size, seed=None):
        super().__init__(seed)
        self.size = size  # (height, width)

    def apply_image(self, image):
        height, width = self.size
        return tools._resize(image, width=width, height=height)

    def apply_keypoints(self, xy, image_shape):
        height, width = self.size
        sy = height / image_shape[0]
        sx = width / image_shape[1]
        return xy * np.array([sx, sy], dtype="float32")

    def output_shape(self, image_shape):
        return tuple(self.size) + tuple(image_shape[2:])
