"""Port parity of the training data path: ``compute_maps`` and the line
helpers of ``tools``, ``get_gaussian_heatmap``, both
``get_batch_generator``s and the label encoder, against the JAX package.

All of it is numpy on the host, the same arithmetic in both packages, so
every comparison is exact.
"""

import string

import numpy as np
import pytest
import torch

from keras_ocr_tpu import detection as jdetection
from keras_ocr_tpu import tools as jtools
from keras_ocr_tpu.data import detection_targets as jtargets
from keras_ocr_tpu.recognition import Recognizer as JaxRecognizer
from keras_ocr_tpu_torch import Detector, Recognizer, detection, tools
from keras_ocr_tpu_torch.data import detection_targets

torch.set_num_threads(2)

TINY_CRNN = {
    "height": 31, "width": 64, "color": False, "filters": (8, 8, 8, 8, 16, 16, 16),
    "rnn_units": (16, 16), "dropout": 0.25, "rnn_steps_to_discard": 2, "pool_size": 2,
    "stn": False,
}
ALPHABET = string.ascii_lowercase[:8] + " "


def _char_box(x, y, w, h, angle=0.0):
    c, s = np.cos(angle), np.sin(angle)
    corners = np.array([[0, 0], [w, 0], [w, h], [0, h]], np.float64)
    return (corners @ np.array([[c, s], [-s, c]]) + [x, y]).astype(np.float32)


def _line(rng, text, x, y, vertical=False, angle=0.0, shuffle=True):
    """(box, character) entries of one line, in shuffled order."""
    size = rng.uniform(8, 20)
    entries = []
    for i, character in enumerate(text):
        step = i * size * 1.1
        dx, dy = (0.0, step) if vertical else (step * np.cos(angle), step * np.sin(angle))
        entries.append((_char_box(x + dx, y + dy, size * rng.uniform(0.7, 1.0), size, angle),
                        character))
    if shuffle:
        entries = [entries[i] for i in rng.permutation(len(entries))]
    return entries


def _lines(case, seed=0):
    rng = np.random.RandomState(seed)
    if case == "horizontal":
        return [_line(rng, "abcdef", 10, 20), _line(rng, "ghab", 30, 90, angle=0.2)]
    if case == "vertical":
        return [_line(rng, "abcde", 40, 10, vertical=True)]
    if case == "spaces":
        return [_line(rng, "ab cd  e", 5, 40), _line(rng, "a b", 60, 100, vertical=True)]
    if case == "degenerate_and_clipped":
        line = _line(rng, "abc", -6, 30, shuffle=False)
        # A quad with coincident corners, and a line past the top-left edge.
        line.append((np.array([[70, 40], [70, 40], [70, 40], [70, 52]], np.float32), "d"))
        return [line, _line(rng, "ef", -12, -5)]
    raise ValueError(case)


CASES = ["horizontal", "vertical", "spaces", "degenerate_and_clipped"]


@pytest.mark.parametrize("case", CASES)
def test_compute_maps_equals_jax(case):
    heatmap = jdetection.get_gaussian_heatmap(size=64, distanceRatio=1.5)
    ref = jtargets.compute_maps(heatmap, 128, 160, _lines(case))
    out = detection_targets.compute_maps(heatmap, 128, 160, _lines(case))
    assert out.dtype == ref.dtype and out.shape == (64, 80, 2)
    assert np.array_equal(out, ref)
    assert out[..., 0].max() > 0.1
    np.testing.assert_array_equal(detection_targets.map_to_rgb(out), jtargets.map_to_rgb(ref))


def test_compute_maps_rejects_odd_sizes():
    heatmap = detection.get_gaussian_heatmap(size=16)
    with pytest.raises(ValueError, match="Height"):
        detection_targets.compute_maps(heatmap, 31, 32, [])
    with pytest.raises(ValueError, match="Width"):
        detection_targets.compute_maps(heatmap, 32, 31, [])


@pytest.mark.parametrize("size, ratio", [(512, 3.34), (64, 1.5), (31, 2.0)])
def test_gaussian_heatmap_equals_jax(size, ratio):
    out = detection.get_gaussian_heatmap(size=size, distanceRatio=ratio)
    ref = jdetection.get_gaussian_heatmap(size=size, distanceRatio=ratio)
    assert out.dtype == ref.dtype == np.uint8
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("case", CASES)
def test_line_helpers_equal_jax(case):
    for line in _lines(case, seed=1):
        fixed, orientation = tools.fix_line(line)
        ref_fixed, ref_orientation = jtools.fix_line(line)
        assert orientation == ref_orientation
        assert [c for _, c in fixed] == [c for _, c in ref_fixed]
        for (box, _), (ref, _) in zip(fixed, ref_fixed):
            np.testing.assert_array_equal(box, ref)
        box, text = tools.combine_line(fixed)
        ref_box, ref_text = jtools.combine_line(ref_fixed)
        assert text == ref_text
        np.testing.assert_array_equal(box, ref_box)
    lines = _lines(case, seed=1)
    assert len(tools.flatten(lines)) == sum(len(line) for line in lines)
    assert [c for _, c in tools.flatten(lines)] == [c for _, c in jtools.flatten(lines)]


@pytest.mark.parametrize("boxes_format", ["boxes", "lines", "predictions"])
@pytest.mark.parametrize("scale", [1, 0.5])
def test_adjust_boxes_equals_jax(boxes_format, scale):
    lines = _lines("horizontal", seed=2)
    if boxes_format == "boxes":
        boxes = np.array([box for box, _ in tools.flatten(lines)])
    elif boxes_format == "lines":
        boxes = lines
    else:
        boxes = [(text, box) for box, text in (tools.combine_line(line) for line in lines)]
    out = tools.adjust_boxes(boxes, scale=scale, boxes_format=boxes_format)
    ref = jtools.adjust_boxes(boxes, scale=scale, boxes_format=boxes_format)
    if boxes_format == "boxes":
        np.testing.assert_array_equal(out, ref)
        return

    def entries(result):
        if boxes_format == "lines":
            return [(np.asarray(box), text) for line in result for box, text in line]
        return [(np.asarray(box), text) for text, box in result]

    assert len(entries(out)) == len(entries(ref)) > 0
    for (box, text), (ref_box, ref_text) in zip(entries(out), entries(ref)):
        assert text == ref_text
        np.testing.assert_array_equal(box, ref_box)


def test_adjust_boxes_rejects_unknown_format():
    with pytest.raises(NotImplementedError):
        tools.adjust_boxes([], scale=2, boxes_format="quads")


def _detector_samples(seed, weighted):
    rng = np.random.RandomState(seed)
    while True:
        image = rng.randint(0, 256, (96, 128, 3)).astype(np.uint8)
        case = CASES[rng.randint(len(CASES))]
        lines = _lines(case, seed=rng.randint(1000))
        yield (image, lines, rng.uniform(0.5, 2)) if weighted else (image, lines)


@pytest.mark.parametrize("weighted", [False, True])
def test_detector_batch_generator_equals_jax(weighted):
    ours = Detector(width=0.125, device="cpu").get_batch_generator(
        _detector_samples(0, weighted), batch_size=3, heatmap_size=64)
    # The JAX generator reads nothing of its detector: no model is built.
    theirs = jdetection.Detector.get_batch_generator(
        None, _detector_samples(0, weighted), batch_size=3, heatmap_size=64)
    for _ in range(2):
        batch, ref = next(ours), next(theirs)
        assert len(batch) == len(ref) == (3 if weighted else 2)
        for value, expected in zip(batch, ref):
            assert value.dtype == expected.dtype
            np.testing.assert_array_equal(value, expected)


@pytest.fixture(scope="module")
def recognizers():
    jax_recognizer = JaxRecognizer(ALPHABET, None, TINY_CRNN)
    return Recognizer(ALPHABET, None, TINY_CRNN, device="cpu"), jax_recognizer


def _recognizer_samples(seed, weighted):
    rng = np.random.RandomState(seed)
    words = ["abc", " hag ", "Bead", "d e f", "h"]
    while True:
        image = rng.randint(0, 256, (31, 64, 3)).astype(np.uint8)
        text = words[rng.randint(len(words))]
        yield (image, text, rng.uniform(0.5, 2)) if weighted else (image, text)


@pytest.mark.parametrize("weighted", [False, True])
def test_recognizer_batch_generator_equals_jax(recognizers, weighted):
    ours, theirs = recognizers
    assert ours.max_string_length() == theirs.max_string_length() == 14
    batches = [r.get_batch_generator(_recognizer_samples(1, weighted), batch_size=4,
                                     lowercase=True) for r in recognizers]
    for _ in range(3):
        batch, ref = next(batches[0]), next(batches[1])
        assert len(batch) == len(ref) == (3 if weighted else 2)
        (inputs, y, *rest), (ref_inputs, ref_y, *ref_rest) = batch, ref
        for value, expected in zip((*inputs, y, *rest), (*ref_inputs, ref_y, *ref_rest)):
            assert value.dtype == expected.dtype
            np.testing.assert_array_equal(value, expected)


@pytest.mark.parametrize("sentence, message", [
    ("", "zero length"),
    ("abcdefgh" * 2, "longer than"),
    ("ab  c", "multiple sequential spaces"),
    ("abz", "illegal character: z"),
])
def test_encode_label_errors_match_jax(recognizers, sentence, message):
    ours, theirs = recognizers
    for recognizer in (ours, theirs):
        with pytest.raises(ValueError, match=message):
            recognizer._encode_label(sentence, recognizer.max_string_length())
    assert ours._encode_label("a b", 6) == theirs._encode_label("a b", 6) == [0, 8, 1, -1, -1, -1]
