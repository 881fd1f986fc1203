"""Port parity: word crops and greedy CTC decoding vs the JAX package.

Crops within 1 uint8 count of ``warp_boxes_batch`` at every window rung,
including a word past the first rung (the antialiased downscale) and a
zero box (an empty slot); ``window_overflow`` and ``ctc_greedy_decode``
exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from keras_ocr_tpu.ops import ctc as jctc
from keras_ocr_tpu.ops import warp as jwarp
from keras_ocr_tpu_torch.ops import ctc, warp

torch.set_num_threads(2)


def _scene(seed, channels):
    rng = np.random.RandomState(seed)
    shape = (2, 120, 700) + ((channels,) if channels > 1 else ())
    images = rng.randint(0, 256, size=shape).astype(np.float32)
    boxes = []
    for _ in range(2):
        for _ in range(5):
            cx, cy = rng.uniform(40, 600), rng.uniform(20, 100)
            w, h = rng.uniform(10, 80), rng.uniform(8, 25)
            angle = rng.uniform(-0.3, 0.3)
            c, s = np.cos(angle), np.sin(angle)
            corners = np.array([[-w, -h], [w, -h], [w, h], [-w, h]]) / 2
            boxes.append(corners @ np.array([[c, s], [-s, c]]) + [cx, cy])
    boxes = np.array(boxes, np.float32).reshape(2, 5, 4, 2)
    boxes[1, 0] = [[5, 10], [650, 14], [648, 60], [3, 56]]  # wider than 512
    boxes[1, 1] = 0.0  # an empty slot
    boxes[0, 2] = boxes[0, 2][[2, 0, 3, 1]]  # corners in scrambled order
    return images, boxes


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("rung", range(len(warp.WINDOW_LADDER)))
def test_warp_within_one_count(channels, rung):
    assert warp.WINDOW_LADDER == jwarp.WINDOW_LADDER
    window_height, window_width = warp.WINDOW_LADDER[rung]
    images, boxes = _scene(rung, channels)
    ref = np.asarray(
        jwarp.warp_boxes_batch(
            jnp.asarray(images), jnp.asarray(boxes),
            window_height=window_height, window_width=window_width,
        )
    )
    out = warp.warp_boxes_batch(
        torch.from_numpy(images), torch.from_numpy(boxes),
        window_height=window_height, window_width=window_width,
    ).numpy()
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() <= 1.0
    mask = np.ones(boxes.shape[:2], bool)
    mask[0, 0] = False
    np.testing.assert_array_equal(
        warp.window_overflow(torch.from_numpy(boxes), torch.from_numpy(mask),
                             window_height, window_width).numpy(),
        np.asarray(jwarp.window_overflow(jnp.asarray(boxes), jnp.asarray(mask),
                                         window_height, window_width)),
    )


def test_wide_word_overflows_only_the_first_rung():
    _, boxes = _scene(0, 1)
    mask = torch.ones(boxes.shape[:2], dtype=torch.bool)
    flags = [
        warp.window_overflow(torch.from_numpy(boxes), mask, h, w).tolist()
        for h, w in warp.WINDOW_LADDER
    ]
    assert flags == [[False, True], [False, False], [False, False]]


def test_order_corners_matches_jax():
    _, boxes = _scene(1, 1)
    for box in boxes.reshape(-1, 4, 2):
        np.testing.assert_array_equal(
            warp.order_corners(torch.from_numpy(box)).numpy(),
            np.asarray(jwarp.order_corners(jnp.asarray(box))),
        )


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ctc_greedy_decode_exact(seed):
    rng = np.random.RandomState(seed)
    probs = rng.rand(6, 48, 37).astype(np.float32)
    # Long runs of one class and of the blank, to exercise the collapse.
    probs[0, :20, 5] = 2.0
    probs[1, :, 36] = 2.0
    probs[2, 10:30, 36] = 2.0
    ref = np.asarray(jctc.ctc_greedy_decode(jnp.asarray(probs)))
    out = ctc.ctc_greedy_decode(torch.from_numpy(probs))
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), ref)
    alphabet = "0123456789abcdefghijklmnopqrstuvwxyz"
    assert ctc.ctc_decode_to_strings(out.numpy(), alphabet) == jctc.ctc_decode_to_strings(
        ref, alphabet
    )
