"""Port parity: get_boxes vs the JAX package on identical heatmaps.

Populations: the synthetic CRAFT-like word heatmaps of
``tests/test_postprocess.py`` (regenerated here), a serpentine that defeats
few sweeps, filter and empty maps, and a component that overlap removal
splits into two dilated blobs. ``mask``, ``n_components``, ``converged`` and
``n_multiblob`` must be exact; boxes within 1e-3 px, except where the
36-angle bank's argmin is a tie between angles of equal rectangle area,
which the test counts and bounds.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from keras_ocr_tpu.ops import postprocess as jpost
from keras_ocr_tpu_torch.ops import postprocess as post

torch.set_num_threads(2)


def _synthetic_heatmap(rng, height=128, width=192, n_words=4):
    """Gaussian char bumps along rotated lines + link bumps between chars."""
    textmap = np.zeros((height, width), dtype="float32")
    linkmap = np.zeros((height, width), dtype="float32")
    yy, xx = np.mgrid[0:height, 0:width]
    for _ in range(n_words):
        n_chars = rng.randint(3, 7)
        cx = rng.uniform(25, width - 25)
        cy = rng.uniform(20, height - 20)
        angle = rng.uniform(-0.5, 0.5)
        spacing = rng.uniform(7, 10)
        sigma = rng.uniform(2.5, 3.5)
        for i in range(n_chars):
            t = (i - (n_chars - 1) / 2) * spacing
            px = cx + t * np.cos(angle)
            py = cy + t * np.sin(angle)
            bump = np.exp(-((xx - px) ** 2 + (yy - py) ** 2) / (2 * sigma**2))
            textmap = np.maximum(textmap, 0.95 * bump.astype("float32"))
            if i > 0:
                lx = cx + (t - spacing / 2) * np.cos(angle)
                ly = cy + (t - spacing / 2) * np.sin(angle)
                lbump = np.exp(-((xx - lx) ** 2 + (yy - ly) ** 2) / (2 * sigma**2))
                linkmap = np.maximum(linkmap, 0.85 * lbump.astype("float32"))
    return np.stack([textmap, linkmap], axis=-1)


def _mega_snake(height=42, width=40):
    fg = np.zeros((height, width), bool)
    for i, row in enumerate(range(1, height - 1, 2)):
        fg[row, 2 : width - 2] = True
        joint = width - 3 if i % 2 == 0 else 2
        if row + 2 < height - 1:
            fg[row + 1, joint] = True
    return fg


def _area(box):
    x, y = box[:, 0], box[:, 1]
    return 0.5 * abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))


def _compare(hm, ties, **kwargs):
    boxes, mask, diag = jpost.get_boxes(jnp.asarray(hm), **kwargs)
    tboxes, tmask, tdiag = post.get_boxes(torch.from_numpy(hm), **kwargs)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(mask))
    for key in ("n_components", "converged", "n_multiblob"):
        np.testing.assert_array_equal(tdiag[key].numpy(), np.asarray(diag[key]), err_msg=key)
    boxes, tboxes = np.asarray(boxes), tboxes.numpy()
    assert tboxes.shape == boxes.shape
    err = np.abs(tboxes - boxes).max(axis=(-1, -2))
    for index in zip(*np.nonzero(err > 1e-3)):
        # A tie: another bank angle with the same rectangle area won.
        assert _area(tboxes[index]) == pytest.approx(_area(boxes[index]), rel=1e-4), index
        ties.append(index)
    return np.asarray(mask), diag


@pytest.mark.parametrize("seed", range(6))
def test_synthetic_population_matches_jax(seed):
    rng = np.random.RandomState(seed)
    hm = np.stack([_synthetic_heatmap(rng, n_words=4 + seed % 3) for _ in range(2)])
    ties = []
    for cap in (4, 64):
        mask, diag = _compare(hm, ties, max_components=cap)
        assert mask.any()
    assert len(ties) <= 2


def test_convergence_flag_matches_jax():
    snake = np.zeros((1,) + _mega_snake().shape + (2,), "float32")
    snake[0, ..., 0] = np.where(_mega_snake(), 0.95, 0.0)
    ties = []
    for sweeps in (1, 8, 32):
        _, diag = _compare(snake, ties, num_sweeps=sweeps)
        assert bool(np.asarray(diag["converged"])[0]) == (sweeps == 32)
    assert not ties


def test_filters_empty_and_multiblob_match_jax():
    hm = np.zeros((3, 64, 96, 2), "float32")
    hm[0, 10:12, 10:12, 0] = 0.9  # area 4 < 10 -> dropped
    hm[0, 30:36, 30:42, 0] = 0.5  # peak 0.5 < 0.7 -> dropped
    hm[0, 50:56, 20:44, 0] = 0.9  # kept
    # Image 1 stays empty. Image 2: a text run whose middle is also link,
    # so the overlap-removed segmap is two islands too far apart for the
    # dilation to re-merge -> one excess dilated blob.
    hm[2, 10:21, 10:61, 0] = 0.9
    hm[2, 10:21, 30:41, 1] = 0.9
    ties = []
    mask, diag = _compare(hm, ties, max_components=16)
    assert mask.sum(1).tolist() == [1, 0, 1]
    assert np.asarray(diag["n_multiblob"]).tolist() == [0, 0, 1]
    assert not ties


def test_per_component_census_matches_jax():
    """``n_dilblobs``, the dilated blobs of each component, exact on maps
    with multi-blob components, and the rest of the analysis unchanged."""
    import sys, os

    sys.path.insert(0, os.path.dirname(__file__))
    from test_refine import _multiblob_heatmap

    hm = np.stack([_multiblob_heatmap(np.random.RandomState(seed), n_words=3) for seed in (0, 4)]
                  + [_synthetic_heatmap(np.random.RandomState(1), height=96, width=128)])
    args = (0.7, 0.4, 0.4, 10, 16)
    out = post.component_analysis(torch.from_numpy(hm), *args, per_component_census=True)
    plain = post.component_analysis(torch.from_numpy(hm), *args)
    assert set(out) == set(plain) | {"n_dilblobs"}
    for key in plain:
        assert torch.equal(out[key], plain[key]), key
    assert out["n_dilblobs"].shape == (3, 16) and out["n_dilblobs"].dtype == torch.float32
    for i in range(len(hm)):
        ref = jpost.component_analysis(jnp.asarray(hm[i]), *args, per_component_census=True)
        np.testing.assert_array_equal(out["n_dilblobs"][i].numpy(), np.asarray(ref["n_dilblobs"]))
    assert out["n_dilblobs"][:2].max() >= 2  # the split words
