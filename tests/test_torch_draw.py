"""The port's drawing and synthetic-scene functions against the JAX
package's, on the CPU: ``tools.drawBoxes`` / ``drawAnnotations``,
``generation._draw_polygon``, ``draw_text_image`` and
``get_image_generator``.

Bars:
- ``drawBoxes`` and ``_draw_polygon`` equal PIL's (the JAX package's)
  pixel for pixel on axis-aligned boxes at thickness 1, 2 and 5; on rotated
  boxes, where ``drawBoxes`` draws round joints, at most 1% of the drawn
  pixels differ;
- with the port's ``_measure`` monkeypatched to return PIL's metrics, the
  ``lines`` of ``draw_text_image`` and of the scenes of
  ``get_image_generator`` equal JAX's exactly (float32 boxes, characters,
  line breaks), and ``random`` / ``np.random`` end in JAX's state. The
  images' mean absolute difference is at most 2 uint8 over each case's
  images: PIL hints glyphs with FreeType, the port fits them to the pixel
  grid by its own rules (``fonts._fit_rows``, ``_fit_columns``), so edges
  can land a pixel apart. Measured: 0.20 and 0.11 on the two
  ``draw_text_image`` cases, 0.83 on the generator's default-font scene,
  0.59 over the four seeded scenes (0.32-1.23 each). One image can pass
  2 on its own: a scene of the same generator from other sentences, with
  DejaVu Serif at 21 px, where the font's own hinting program rounds its
  x-height down and the port rounds it to the nearest pixel, measured
  2.16 (0.92 over its four).
  The recognizer crops of the default font's 10-px lines, cut and scaled
  about 3x, differ by at most 12 (measured 2.7-7.9) and carry the same
  sentences;
- with the port's own metrics the scenes hold the same sentences, their
  characters in the same order, and the generators end in JAX's state.
"""

import functools
import itertools
import random
import string

import numpy as np
import PIL.ImageFont
import pytest

from keras_ocr_tpu import tools as jtools
from keras_ocr_tpu.data import generation as jgen
from keras_ocr_tpu_torch import data_generation, tools
from keras_ocr_tpu_torch.data import generation

DEJAVU = "/usr/share/fonts/truetype/dejavu/"
SANS, SERIF, MONO = (DEJAVU + name for name in ("DejaVuSans.ttf", "DejaVuSerif.ttf",
                                                 "DejaVuSansMono.ttf"))


def _axis_boxes(rng, count):
    boxes = []
    for _ in range(count):
        x0, y0 = rng.uniform(-10, 110, 2)
        w, h = rng.uniform(3, 70, 2)
        if rng.random() < 0.5:
            x0, y0, w, h = round(x0), round(y0), round(w), round(h)
        boxes.append(np.array([[x0, y0], [x0 + w, y0], [x0 + w, y0 + h], [x0, y0 + h]],
                              dtype="float32"))
    return boxes


def _rotated_boxes(rng, count):
    boxes = []
    for _ in range(count):
        centre = rng.uniform(20, 140, 2)
        w, h = rng.uniform(6, 70, 2)
        angle = rng.uniform(0, np.pi)
        rotation = np.array([[np.cos(angle), -np.sin(angle)], [np.sin(angle), np.cos(angle)]])
        corners = np.array([[-w, -h], [w, -h], [w, h], [-w, h]]) / 2
        boxes.append((corners @ rotation.T + centre).astype("float32"))
    return boxes


@pytest.mark.parametrize("thickness", [1, 2, 5])
@pytest.mark.parametrize("boxes_format", ["boxes", "lines", "predictions"])
def test_draw_boxes_equals_pil_on_axis_aligned_boxes(thickness, boxes_format):
    rng = np.random.default_rng(thickness)
    image = rng.integers(0, 256, (130, 170, 3)).astype(np.uint8)
    boxes = _axis_boxes(rng, 12)
    if boxes_format == "lines":
        boxes = [[(box, "a") for box in boxes[:5]], [(box, "b") for box in boxes[5:]]]
    elif boxes_format == "predictions":
        boxes = [("word", box) for box in boxes]
    ours = tools.drawBoxes(image, boxes, color=(0, 255, 10), thickness=thickness,
                           boxes_format=boxes_format)
    theirs = jtools.drawBoxes(image, boxes, color=(0, 255, 10), thickness=thickness,
                              boxes_format=boxes_format)
    np.testing.assert_array_equal(ours, theirs)
    assert (ours != image).any()
    assert tools.drawBoxes(image, []) is image


@pytest.mark.parametrize("thickness", [1, 2, 5])
@pytest.mark.parametrize("bands", [3, 4])
def test_draw_polygon_equals_pil_on_axis_aligned_boxes(thickness, bands):
    rng = np.random.default_rng(10 + thickness)
    image = rng.integers(0, 256, (130, 170, bands)).astype(np.uint8)
    color = (255, 0, 0, 255)[:bands]
    for box in _axis_boxes(rng, 6):
        np.testing.assert_array_equal(
            generation._draw_polygon(image, box, color, thickness),
            jgen._draw_polygon(image, box, color, thickness))


@pytest.mark.parametrize("thickness", [1, 3, 5, 6, 9, 12])
def test_rotated_boxes_and_round_joints_within_one_percent(thickness):
    rng = np.random.default_rng(20 + thickness)
    image = np.zeros((160, 180, 3), dtype=np.uint8)
    boxes = _rotated_boxes(rng, 15)
    ours = tools.drawBoxes(image, boxes, thickness=thickness)
    theirs = jtools.drawBoxes(image, boxes, thickness=thickness)
    drawn = (ours.any(-1) | theirs.any(-1)).sum()
    differ = (ours != theirs).any(-1).sum()
    assert differ <= 0.01 * drawn, (differ, drawn)
    plain = [generation._draw_polygon(image, box, (255, 0, 0), thickness) for box in boxes]
    want = [jgen._draw_polygon(image, box, (255, 0, 0), thickness) for box in boxes]
    np.testing.assert_array_equal(np.stack(plain), np.stack(want))


def test_draw_annotations_matches_jax():
    matplotlib = pytest.importorskip("matplotlib")
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    rng = np.random.default_rng(3)
    image = rng.integers(0, 256, (120, 200, 3)).astype(np.uint8)
    predictions = [(f"w{i}", box) for i, box in enumerate(_axis_boxes(rng, 6))]
    results = []
    for module in (tools, jtools):
        fig, ax = plt.subplots()
        assert module.drawAnnotations(image, predictions, ax=ax) is ax
        results.append(([(t.get_text(), t.xy, t.xyann) for t in ax.texts],
                        ax.images[0].get_array()))
        plt.close(fig)
    (texts, shown), (want_texts, want_shown) = results
    assert texts == want_texts and len(texts) == 6
    np.testing.assert_array_equal(shown, want_shown)


@functools.lru_cache(maxsize=None)
def _pil_font(path, size):
    return PIL.ImageFont.load_default() if path is None else PIL.ImageFont.truetype(path, size)


def _pil_measure(font, character):
    """PIL's metrics for the port's font (same file and size)."""
    return _pil_font(font.path, font.size).font.getsize(character)


def _assert_lines_equal(ours, theirs):
    assert len(ours) == len(theirs)
    for line, want in zip(ours, theirs):
        assert [c for _, c in line] == [c for _, c in want]
        for (box, _), (want_box, _) in zip(line, want):
            assert box.dtype == want_box.dtype == np.float32
            np.testing.assert_array_equal(box, want_box)


def _run_both(make, seed):
    """``make(module)`` for the port and for JAX from the same seeds: the
    results and whether both end in the same generator state."""
    results, states = [], []
    for module in (generation, jgen):
        random.seed(seed)
        np.random.seed(seed)
        results.append(make(module))
        states.append((random.getstate(), np.random.get_state()))
    (py, np_state), (want_py, want_np) = states
    same_state = (py == want_py and np_state[0] == want_np[0]
                  and np.array_equal(np_state[1], want_np[1]) and np_state[2:] == want_np[2:])
    return results, same_state


def _mean_abs(a, b):
    return np.abs(np.asarray(a, dtype=np.float64) - np.asarray(b, dtype=np.float64)).mean()


@pytest.fixture
def pil_metrics(monkeypatch):
    monkeypatch.setattr(generation, "_measure", _pil_measure)


DRAW_CASES = {
    # tests/test_data.py's draw_text_image input.
    "jax-test-input": dict(text="hello world", fontsize=16, height=100, width=200,
                           fonts={"helo wrd": None}),
    "rotated-ligatures": dict(
        text="The fifth flag fluttered, 61 birds", fontsize=22, height=240, width=320,
        fonts={string.ascii_letters + " ,": SERIF, string.digits: SANS}, use_ligatures=True,
        thetaX=0.03, thetaY=-0.02, thetaZ=0.2, color=(10, 20, 30), draw_contour=True),
}


@pytest.mark.parametrize("case", list(DRAW_CASES))
def test_draw_text_image_matches_jax_given_pils_metrics(case, pil_metrics):
    kwargs = DRAW_CASES[case]
    (ours, theirs), same_state = _run_both(lambda m: m.draw_text_image(**kwargs), 0)
    (image, lines), (want_image, want_lines) = ours, theirs
    assert image.shape == want_image.shape and image.dtype == np.uint8
    _assert_lines_equal(lines, want_lines)
    assert sum(len(line) for line in lines) >= 4
    assert _mean_abs(image, want_image) <= 2
    assert same_state


def test_jax_image_generator_test_input_matches_given_pils_metrics(pil_metrics):
    """tests/test_data.py's generator case: the default font, then the
    recognizer-input conversion."""

    def make(module):
        text_gen = module.get_text_generator(alphabet=string.ascii_lowercase + " ",
                                             lowercase=True)
        image_gen = module.get_image_generator(
            height=160, width=256, font_groups={string.ascii_lowercase + " ": [None]},
            text_generator=text_gen, font_size=14)
        scene = next(image_gen)
        crops = module.convert_image_generator_to_recognizer_input(
            image_generator=image_gen, max_string_length=8, target_width=200,
            target_height=31)
        return scene, [next(crops) for _ in range(3)]

    (ours, theirs), same_state = _run_both(make, 1)
    (image, lines), crops = ours
    (want_image, want_lines), want_crops = theirs
    _assert_lines_equal(lines, want_lines)
    assert image.shape == (160, 256, 3) and _mean_abs(image, want_image) <= 2
    for (crop, sentence), (want_crop, want_sentence) in zip(crops, want_crops):
        assert sentence == want_sentence and crop.shape == (31, 200, 3)
        assert _mean_abs(crop, want_crop) <= 12
    assert same_state


def _scenes(module, count=4, draw_contour=False):
    backgrounds = [tools.read("tests/fixtures/golden_offline/scene_00.png"),
                   tools.read("tests/fixtures/golden_offline/scene_03.png"),
                   tools.read("tests/fixtures/test_image.jpg")]
    # Two sentences full of "fi" / "fl" first, so that ligatures are drawn.
    text_gen = itertools.chain(
        ["Fifty flat fish float in a fine fjord 42", "The official flow of affluent fireflies"],
        module.get_text_generator(alphabet=string.ascii_letters + string.digits + " ",
                                  rng=random.Random(5)))
    image_gen = module.get_image_generator(
        height=256, width=320,
        font_groups={string.ascii_letters + " ": [SANS, SERIF], string.digits: [MONO]},
        text_generator=text_gen, font_size=(18, 30), backgrounds=backgrounds,
        rotationX=(-0.05, 0.05), rotationY=(-0.05, 0.05), rotationZ=(-15, 15), margin=10,
        use_ligatures=True, draw_contour=draw_contour, draw_contour_text=draw_contour)
    return [next(image_gen) for _ in range(count)]


@pytest.mark.parametrize("draw_contour", [False, True], ids=["plain", "contours"])
def test_seeded_scenes_match_jax_given_pils_metrics(draw_contour, pil_metrics):
    (ours, theirs), same_state = _run_both(
        lambda m: _scenes(m, count=4 if not draw_contour else 1, draw_contour=draw_contour), 3)
    ligatures = 0
    for (image, lines), (want_image, want_lines) in zip(ours, theirs):
        _assert_lines_equal(lines, want_lines)
        assert image.shape == (256, 320, 3)
        text = "".join(c for line in lines for _, c in line)
        ligatures += text.count("fi") + text.count("fl")
    assert _mean_abs(np.stack([image for image, _ in ours]),
                     np.stack([image for image, _ in theirs])) <= 2
    assert sum(len(lines) for _, lines in ours) >= 2 * len(ours)
    if not draw_contour:
        assert ligatures > 0
    assert same_state


def test_seeded_scenes_with_the_ports_own_metrics():
    """Unhinted metrics move glyphs by a pixel and may wrap a line
    elsewhere, but the sentences, the order of their characters and the
    generators' draws stay JAX's."""
    (ours, theirs), same_state = _run_both(lambda m: _scenes(m, count=4), 3)
    for (_, lines), (_, want_lines) in zip(ours, theirs):
        text = "".join(c for line in lines for _, c in line if c != " ")
        want = "".join(c for line in want_lines for _, c in line if c != " ")
        assert text and (text.startswith(want) or want.startswith(text)), (text, want)
    assert same_state


def test_data_generation_binds_the_rendering_names():
    for name in ("draw_text_image", "get_image_generator", "get_fonts",
                 "font_supports_alphabet"):
        assert getattr(data_generation, name) is getattr(generation, name)
