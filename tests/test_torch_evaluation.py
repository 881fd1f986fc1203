"""Port parity: ``evaluation`` (polygon IoU, Levenshtein, ``score``) against
the JAX package, with exact equality.

The inputs of ``tests/test_evaluation.py``, then seeded rotated quads,
random strings and annotation dicts with "ignore" ground truth, a
translator and zero-area boxes, through both packages.
"""

import warnings

import numpy as np
import pytest

from keras_ocr_tpu import evaluation as jevaluation
from keras_ocr_tpu_torch import evaluation

SQUARE = np.array([[0, 0], [10, 0], [10, 10], [0, 10]])
PAIRS = [
    (SQUARE, SQUARE + 5),  # quarter overlap
    (SQUARE, SQUARE + 20),  # disjoint
    (SQUARE, SQUARE),
    ([(0, 0), (10, 10)], [(0, 0), (10, 10)]),  # two-point format
    (SQUARE, np.array([[5, 0], [10, 5], [5, 10], [0, 5]])),  # rotated inside
    (np.array([[5, 0], [10, 5], [5, 10], [0, 5]]), np.array([[7, 0], [12, 5], [7, 10], [2, 5]])),
    (SQUARE[::-1], SQUARE + 3),  # clockwise clip polygon
]


def _quad(rng):
    center = rng.uniform(0, 60, 2)
    width, height = rng.uniform(0.5, 40), rng.uniform(0.5, 15)
    c, s = np.cos(a := rng.uniform(-np.pi, np.pi)), np.sin(a)
    half = np.array([[-width, -height], [width, -height], [width, height], [-width, height]]) / 2
    return half @ np.array([[c, s], [-s, c]]) + center


def _word(rng):
    return "".join(rng.choice(list("abcde "), size=rng.randint(0, 7)))


def _both(fn, *args, **kwargs):
    """fn of both packages with their warnings; results and warning texts
    must be equal."""
    results = []
    for module in (evaluation, jevaluation):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = getattr(module, fn)(*args, **kwargs)
        results.append((out, [str(w.message) for w in caught]))
    assert results[0] == results[1]
    return results[0][0]


@pytest.mark.parametrize("pair", range(len(PAIRS)))
def test_iou_score_test_inputs_exact(pair):
    box1, box2 = PAIRS[pair]
    _both("iou_score", box1, box2)
    _both("iou_score", box2, box1)


def test_iou_score_seeded_quads_exact():
    rng = np.random.RandomState(0)
    scores = [_both("iou_score", _quad(rng), _quad(rng)) for _ in range(300)]
    base = _quad(rng)
    scores += [_both("iou_score", base, base + rng.uniform(-3, 3, 2)) for _ in range(100)]
    assert sum(0 < s < 1 for s in scores) > 50
    # Boxes that truncate to zero area under the int32 cast warn and score 0.
    assert _both("iou_score", [[0, 0], [0.5, 0], [0.5, 0.5], [0, 0.5]], SQUARE) == 0


def test_levenshtein_exact():
    rng = np.random.RandomState(1)
    pairs = [("kitten", "sitting"), ("", "abc"), ("abc", "abc"), ("flaw", "lawn"), ("", "")]
    pairs += [(_word(rng), _word(rng)) for _ in range(300)]
    for a, b in pairs:
        assert _both("levenshtein", a, b) == _both("levenshtein", b, a)


def _annotations(rng, images, count, base=None):
    """image id -> annotation lists; with ``base``, predictions near its
    boxes (some far, some texts changed) plus spurious ones."""
    out = {}
    for image_id in images:
        anns = []
        if base is None:
            for _ in range(rng.randint(0, count)):
                ann = {"text": _word(rng), "vertices": _quad(rng)}
                if rng.rand() < 0.2:
                    ann["ignore"] = True
                anns.append(ann)
        else:
            for ann in base[image_id]:
                if rng.rand() < 0.2:
                    continue
                shift = rng.uniform(-2, 2, 2) if rng.rand() < 0.8 else rng.uniform(20, 40, 2)
                text = ann["text"] if rng.rand() < 0.6 else _word(rng)
                anns.append({"text": text.upper() if rng.rand() < 0.3 else text,
                             "vertices": ann["vertices"] + shift})
            anns += [{"text": _word(rng), "vertices": _quad(rng)}
                     for _ in range(rng.randint(0, 3))]
        out[image_id] = anns
    return out


def test_score_test_inputs_exact():
    box = [[0, 0], [10, 0], [10, 10], [0, 10]]
    far = [[100, 100], [110, 100], [110, 110], [100, 110]]
    missed = [[200, 200], [210, 200], [210, 210], [200, 210]]
    other = [[50, 50], [60, 50], [60, 60], [50, 60]]
    cases = [
        ({"im": [{"text": "hello", "vertices": box}]}, {"im": [{"text": "hello", "vertices": box}]}),
        ({"im": [{"text": "hello", "vertices": box}, {"text": "missed", "vertices": missed}]},
         {"im": [{"text": "zzzzz", "vertices": box}, {"text": "spurious", "vertices": far}]}),
        ({"im": [{"text": "hello", "vertices": box, "ignore": True},
                 {"text": "kept", "vertices": other}]},
         {"im": [{"text": "anything", "vertices": box}, {"text": "kept", "vertices": other}]}),
        ({"im": []}, {"im": []}),  # the 0.0 guards
    ]
    for true, pred in cases:
        _both("score", true, pred)


@pytest.mark.parametrize("seed", range(4))
def test_score_seeded_annotations_exact(seed):
    rng = np.random.RandomState(seed)
    images = [f"im{i}" for i in range(5)]
    true = _annotations(rng, images, 8)
    pred = _annotations(rng, images, 8, base=true)
    translator = str.maketrans("ABCDE", "abcde")
    for kwargs in ({}, {"iou_threshold": 0.3, "similarity_threshold": 0.8},
                   {"translator": translator}):
        results, (precision, recall) = _both("score", true, pred, **kwargs)
        assert 0.0 <= precision <= 1.0 and 0.0 <= recall <= 1.0
    assert sum(len(v) for v in results.values()) > 0
