"""Port parity: the font-free part of ``data/generation.py`` vs the JAX package.

``get_rotation_matrix``, ``get_maximum_uniform_contour`` (the largest light
or dark region's traced boundary), ``compute_transformed_contour`` (which
character slots survive a 3-D rotation), ``point_in_contour`` against JAX's
``matplotlib.path`` test (inside, outside, on edges and at vertices of
simple polygons and of traced contours), the sentence generator from one
seed, the line helpers, ``convert_image_generator_to_recognizer_input``,
the scene compositor's samplers and background staging (one ``random`` /
``np.random`` seed), and ``get_backgrounds`` on a cache filled here with
``urlopen`` refused: equal values, polygons within 1e-9.
"""

import os
import random
import urllib.request

import numpy as np
import pytest
import torch

from keras_ocr_tpu import tools as jtools
from keras_ocr_tpu.data import augmentation as jaug
from keras_ocr_tpu.data import generation as jgen
from keras_ocr_tpu_torch import data_generation as alias
from keras_ocr_tpu_torch import tools
from keras_ocr_tpu_torch.data import augmentation as taug
from keras_ocr_tpu_torch.data import generation as gen

torch.set_num_threads(2)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
BAR = 1e-9


def _scene(seed, height=96, width=128):
    """Noise with a light block and a dark block, the light one larger."""
    rng = np.random.RandomState(seed)
    image = rng.randint(60, 200, size=(height, width, 3)).astype(np.uint8)
    image[8:70, 10:90] = 240
    image[60:90, 95:125] = 15
    return image


@pytest.mark.parametrize("angles", [(0, 0, 0), (0.1, -0.2, 0.3), (0.4, 0.0, -0.6)])
def test_rotation_matrix_and_transformed_contour_match_jax(angles):
    matrix = gen.get_rotation_matrix(128, 96, *angles)
    np.testing.assert_allclose(matrix, jgen.get_rotation_matrix(128, 96, *angles), rtol=0,
                               atol=BAR)
    contours = [np.array([[0, 0], [128, 0], [128, 96], [0, 96]], "float32"),
                np.array([[10, 5], [110, 20], [100, 90], [20, 70]], "float32"),
                jgen.get_maximum_uniform_contour(_scene(1), fontsize=8)[0]]
    for contour in contours:
        for fontsize in (6, 11):
            got = gen.compute_transformed_contour(128, 96, fontsize, matrix, contour)
            want = jgen.compute_transformed_contour(128, 96, fontsize, matrix, contour)
            assert (got is None) == (want is None)
            if got is not None:
                assert got.shape == want.shape and len(got) > 3
                np.testing.assert_allclose(got, want, rtol=0, atol=BAR)


@pytest.mark.parametrize("margin", [0, 5])
@pytest.mark.parametrize("fontsize", [4, 9, 40])
def test_maximum_uniform_contour_matches_jax(fontsize, margin):
    for seed in range(3):
        image = _scene(seed)
        if seed == 2:
            image = 255 - image  # the dark region wins
        got, dark = gen.get_maximum_uniform_contour(image, fontsize, margin=margin)
        want, want_dark = jgen.get_maximum_uniform_contour(image, fontsize, margin=margin)
        assert dark == want_dark
        assert (got is None) == (want is None)
        if got is not None:
            np.testing.assert_allclose(got, want, rtol=0, atol=BAR)


def _polygons():
    square = np.array([[2, 2], [12, 2], [12, 12], [2, 12]], "float64")
    concave = np.array([[0, 0], [20, 0], [20, 20], [10, 8], [0, 20]], "float64")
    triangle = np.array([[3, 1], [17, 9], [1, 15]], "float64")
    collinear = np.array([[0, 0], [5, 0], [10, 0], [10, 10], [5, 10], [0, 10]], "float64")
    traced = jgen.get_maximum_uniform_contour(_scene(3), fontsize=6)[0]
    return {"square": square, "concave": concave, "triangle": triangle,
            "collinear": collinear, "traced": traced}


@pytest.mark.parametrize("name", list(_polygons()))
def test_point_in_contour_matches_matplotlib(name):
    """Integer points, as the callers truncate them: inside, outside, on
    every edge and at every vertex (a point on the boundary is inside)."""
    polygon = _polygons()[name]
    low, high = polygon.min(0) - 2, polygon.max(0) + 3
    xs, ys = np.meshgrid(np.arange(low[0], high[0]), np.arange(low[1], high[1]))
    points = np.stack([xs.ravel(), ys.ravel()], 1)
    got = gen._PolygonTester(polygon).contains(points)
    np.testing.assert_array_equal(got, jgen._PolygonTester(polygon).contains(points))
    for vertex in polygon:
        assert gen.point_in_contour(polygon, vertex)
    if name != "traced":
        midpoints = (polygon + np.roll(polygon, -1, 0)) / 2
        for point in midpoints:
            assert gen.point_in_contour(polygon, point) == jgen.point_in_contour(polygon, point)
            assert gen.point_in_contour(polygon, point)
    assert not gen.point_in_contour(polygon, high + 5)
    assert not gen._PolygonTester(polygon[:2]).contains(points).any()
    assert gen._PolygonTester(polygon).contains(np.zeros((0, 2))).shape == (0,)


@pytest.mark.parametrize("kwargs", [dict(), dict(alphabet="abcdef ", lowercase=True),
                                    dict(max_string_length=12)], ids=["plain", "alphabet",
                                                                      "length"])
def test_text_generator_matches_jax(kwargs):
    ours = gen.get_text_generator(rng=random.Random(7), **kwargs)
    theirs = jgen.get_text_generator(rng=random.Random(7), **kwargs)
    assert [next(ours) for _ in range(50)] == [next(theirs) for _ in range(50)]
    default = alias.get_text_generator()
    assert next(default) == next(jgen.get_text_generator())


def _lines():
    box = lambda x: np.array([[x, 10], [x + 8, 10], [x + 8, 22], [x, 22]], "float32")  # noqa: E731
    return [[(box(5), " "), (box(14), "a"), (box(23), " "), (box(32), " "), (box(41), "b"),
             (box(50), " ")], [(box(5), " ")], [], [(box(60), "c"), (box(69), "d")]]


def test_line_helpers_match_jax():
    lines = _lines()
    assert [[c for _, c in line] for line in gen._strip_lines(lines)] == [
        [c for _, c in line] for line in jgen._strip_lines(lines)]
    assert gen._strip_line(lines[1]) == jgen._strip_line(lines[1]) == []
    assert gen.convert_lines_to_paragraph(lines) == jgen.convert_lines_to_paragraph(lines)


def test_recognizer_input_conversion_matches_jax():
    image = tools.read(os.path.join(FIXTURES, "test_image.jpg"))[:60, :100].copy()

    def scenes():
        yield image, []
        while True:
            yield image, _lines()

    got = gen.convert_image_generator_to_recognizer_input(scenes(), 4, 64, 16, margin=2)
    want = jgen.convert_image_generator_to_recognizer_input(scenes(), 4, 64, 16, margin=2)
    for _ in range(4):
        (crop, text), (want_crop, want_text) = next(got), next(want)
        assert crop.shape == (16, 64, 3) and text == want_text
        np.testing.assert_array_equal(crop, want_crop)


def test_compositor_samplers_match_jax():
    results = []
    for module, aug in ((gen, taug), (jgen, jaug)):
        random.seed(3)
        np.random.seed(3)
        robin = module._RoundRobin("xyz")
        augmenter = aug.Sequential([aug.Multiply((0.5, 1.5)), aug.Affine(rotate=(-5, 5))],
                                   seed=2)
        background = module._stage_background(os.path.join(FIXTURES, "progressive.jpg"),
                                              width=200, height=100, crop_mode="crop",
                                              augmenter=augmenter)
        letterbox = module._stage_background(_scene(0), 80, 120, "letterbox", None)
        results.append(([module._sample_size((10, 30)) for _ in range(5)]
                        + [module._sample_size(18), module._sample_angle(7)]
                        + [module._sample_angle((-30, 30)) for _ in range(5)]
                        + [robin.advance() + str(robin.wrapped) for _ in range(4)]
                        + [module._ink_color(dark) for dark in (True, False)],
                        background, letterbox))
    assert results[0][0] == results[1][0]
    for got, want in zip(results[0][1:], results[1][1:]):
        np.testing.assert_array_equal(got, want)


def test_get_backgrounds_offline(tmp_path, monkeypatch):
    refused = []
    monkeypatch.setattr(urllib.request, "urlopen", lambda *a, **k: refused.append(a))
    folder = tmp_path / "backgrounds"
    folder.mkdir()
    for i in range(1035):
        (folder / f"{i:04d}.jpg").write_bytes(b"")
    got = gen.get_backgrounds(cache_dir=str(tmp_path))
    assert sorted(got) == sorted(jgen.get_backgrounds(cache_dir=str(tmp_path)))
    assert len(got) == 1035 and not refused
    extracted = []
    monkeypatch.setattr(tools, "download_and_extract",
                        lambda **kwargs: extracted.append(kwargs["destination"]))
    monkeypatch.setattr(jtools, "download_and_extract",
                        lambda **kwargs: extracted.append(kwargs["destination"]))
    (folder / "0000.jpg").unlink()
    assert len(gen.get_backgrounds(cache_dir=str(tmp_path))) == 1034
    assert len(jgen.get_backgrounds(cache_dir=str(tmp_path))) == 1034
    assert extracted == [str(folder)] * 2 and not refused
