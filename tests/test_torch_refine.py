"""Port parity: the contours[0] refine pass vs the JAX package.

Populations of ``tests/test_refine.py``: the multi-blob heatmaps of 8
seeds, the word whose tier-1 box is a superset, and the blob nested in
another blob's hole. ``refine_ok`` and ``n_flagged`` must be exact and the
boxes within 1e-3 px of JAX ``refine_boxes``, except where the angle bank's
argmin is a tie between angles of equal rectangle area (counted, as in
``test_torch_postprocess.py``); the refined boxes must also agree with the
port's host oracle within 3 px, the bar of ``tests/test_refine.py``. The
escalation contract runs at windows small enough for an unmarked test.
One JAX compile serves the population (a shared fixture).
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from keras_ocr_tpu.ops import refine as jrefine
from keras_ocr_tpu_torch import detection
from keras_ocr_tpu_torch.ops import postprocess as post
from keras_ocr_tpu_torch.ops import refine

sys.path.insert(0, os.path.dirname(__file__))
from test_refine import _canon, _multiblob_heatmap  # noqa: E402
from test_torch_postprocess import _area  # noqa: E402

torch.set_num_threads(2)


def _nested_heatmap():
    """``tests/test_refine.py``'s ring with an island in its hole, bridged
    to a far island: one component whose contours[0] skips the nested blob."""
    text = np.zeros((64, 64), "float32")
    link = np.zeros((64, 64), "float32")
    text[10:30, 10:30] = 0.95
    text[16:24, 16:24] = 0.45
    link[15:25, 15:25] = 0.5
    text[18:22, 18:22] = 0.95
    link[17:23, 17:23] = 0.3
    link[18:22, 18:22] = 0.35
    text[19:21, 30:50] = 0.45
    link[19:21, 29:51] = 0.5
    text[12:28, 50:58] = 0.9
    return np.stack([text, link], -1)


def _wide_word():
    """A split word 100 columns wide: wider than a 64-column window."""
    text = np.zeros((96, 128), "float32")
    link = np.zeros((96, 128), "float32")
    text[40:56, 6:50] = 0.95
    text[40:56, 70:110] = 0.9
    text[45:50, 50:70] = 0.45
    link[45:50, 46:74] = 0.5
    return np.stack([text, link], -1)


def _population():
    """(12, 96, 128, 2): the 8 seeded multi-blob maps, the superset word,
    the nested blob, the wide word and an empty map."""
    hms = [_multiblob_heatmap(np.random.RandomState(seed)) for seed in range(8)]
    hms.append(_multiblob_heatmap(np.random.RandomState(3), n_words=1))
    nested = np.zeros((96, 128, 2), "float32")
    nested[:64, :64] = _nested_heatmap()
    hms += [nested, _wide_word(), np.zeros((96, 128, 2), "float32")]
    return np.stack(hms)


def _port_refine(hm, max_components=64, **kwargs):
    """Tier 1 and the refine pass of the port on one analysis; returns the
    tier-1 boxes, the mask and refine's (boxes, ok, n_flagged)."""
    analysis = post.component_analysis(
        torch.from_numpy(hm), 0.7, 0.4, 0.4, 10, max_components, per_component_census=True
    )
    boxes, mask, _ = post.get_boxes(
        torch.from_numpy(hm), max_components=max_components, analysis=analysis
    )
    out = refine.refine_boxes(
        torch.from_numpy(hm), boxes, max_components=max_components, analysis=analysis, **kwargs
    )
    return boxes, mask.numpy(), tuple(t.numpy() for t in out)


@pytest.fixture(scope="module")
def population():
    """The port's run at the refine defaults (level 1's window, clamped to
    the 96x128 maps), and JAX ``refine_boxes`` on the same tier-1 boxes
    (those of ``get_boxes`` agree between the packages:
    ``test_torch_postprocess.py``)."""
    hm = _population()
    tier1, mask, port = _port_refine(hm)
    ref = jrefine.refine_boxes(jnp.asarray(hm), jnp.asarray(tier1.numpy()), max_components=64)
    return hm, mask, port, tuple(np.asarray(r) for r in ref)


def test_population_matches_jax(population):
    _, _, (boxes, ok, n_flagged), (jboxes, jok, jn_flagged) = population
    np.testing.assert_array_equal(ok, jok)
    np.testing.assert_array_equal(n_flagged, jn_flagged)
    assert n_flagged.dtype == np.int32 and ok.dtype == bool
    assert ok.all() and (n_flagged[:11] >= 1).all() and n_flagged[11] == 0
    err = np.abs(boxes - jboxes).max(axis=(-1, -2))
    ties = list(zip(*np.nonzero(err > 1e-3)))
    for index in ties:
        # A tie: another bank angle with the same rectangle area won.
        assert _area(boxes[index]) == pytest.approx(_area(jboxes[index]), rel=1e-4), index
    assert len(ties) <= 1


def test_population_matches_the_oracle(population):
    """The refined boxes are the host oracle's contours[0] fits (3 px, the
    bar of ``tests/test_refine.py``), the nested blob skipped."""
    hm, mask, (boxes, _, _), _ = population
    host = detection.getBoxes(hm)
    for i, image_boxes in enumerate(detection.boxes_from_mask(boxes, mask)):
        assert len(image_boxes) == len(host[i]), i
        np.testing.assert_allclose(_canon(image_boxes), _canon(host[i]), atol=3.0)


def test_refine_escalates_past_small_window(population):
    """The wide word fails at a 32x64 window and passes at the 96x128 one
    the population ran at (the escalation contract of the ladder)."""
    hm, _, (_, ok, n_flagged), _ = population
    _, _, (_, small_ok, small_n) = _port_refine(
        hm[10:11], refine_cap=4, window_h=32, window_w=64, max_dilate=8, num_iters=8
    )
    assert small_n[0] == n_flagged[10] == 1
    assert not small_ok[0] and ok[10]


def test_refine_cap_above_components():
    """R = C when the cap exceeds the components (level 3's 32 slots over
    16 components): the same boxes and proofs as a cap of exactly C."""
    hm = _population()[[4, 9, 11]]
    level = dict(window_h=4096, window_w=4096, max_dilate=128, num_iters=16)
    _, _, (boxes, ok, n) = _port_refine(hm, max_components=16, refine_cap=32, **level)
    _, _, (boxes_c, ok_c, n_c) = _port_refine(hm, max_components=16, refine_cap=16, **level)
    np.testing.assert_array_equal(boxes, boxes_c)
    np.testing.assert_array_equal(ok, ok_c)
    np.testing.assert_array_equal(n, n_c)
    assert ok.all() and not boxes[2].any()
