"""Port parity for the two-stage recognition path: the host geometry and
crops of ``tools``, ``rgb_to_grayscale_host``, ``Recognizer.recognize`` /
``recognize_from_boxes`` and ``Pipeline.recognize(...,
recognition_kwargs=...)``, against the JAX package on the CPU.

Geometry and grey conversion must be exact; host ``warpBox`` crops within
1 uint8 count and exact on at least 99.9% of pixels; decoded strings
exactly equal. The golden artifact's slim recognizer (no STN) reads real
word crops, so its argmax has no ties. JAX compiles are kept few: the
recognizer sees one crop count per case.
"""

import os

import numpy as np
import pytest
import torch

from keras_ocr_tpu import evaluation as jevaluation
from keras_ocr_tpu import recognition as jrecognition
from keras_ocr_tpu import tools as jtools
from keras_ocr_tpu.utils import golden as jgolden
from keras_ocr_tpu_torch import Pipeline, Recognizer, recognition, tools
from keras_ocr_tpu_torch.utils import golden

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "fixtures", "golden_offline")
SCENES = ["scene_00.png", "scene_01.png"]


def _quad(center, width, height, angle):
    """Corners of a ``width`` x ``height`` rectangle turned by ``angle``."""
    c, s = np.cos(angle), np.sin(angle)
    half = np.array([[-width, -height], [width, -height], [width, height], [-width, height]]) / 2
    return half @ np.array([[c, s], [-s, c]]) + center


def _boxes(seed, count, shape):
    """Seeded boxes over an image of ``shape``: rotated quads in random
    corner order, some reaching past the border; axis-aligned ones flush
    with an edge; thin ones 1-2 px high; and quads with a repeated
    corner."""
    rng = np.random.RandomState(seed)
    height, width = shape[:2]
    boxes = []
    for _ in range(count):
        center = rng.uniform(-5, [width + 5, height + 5])
        quad = _quad(center, rng.uniform(3, 90), rng.uniform(3, 30), rng.uniform(-np.pi, np.pi))
        boxes.append(quad[rng.permutation(4)])
    for x0, y0, x1, y1 in ((0, 0, 40, 12), (width - 30, height - 9, width, height),
                           (0, 5, width, 25), (10, 0, 60, height - 1)):
        boxes.append(np.array([[x0, y0], [x1, y0], [x1, y1], [x0, y1]], float))
    for _ in range(4):
        center = rng.uniform(10, [width - 10, height - 10])
        boxes.append(_quad(center, rng.uniform(10, 40), rng.uniform(1.0, 2.0), rng.uniform(0, 1)))
    for _ in range(4):
        quad = _quad(rng.uniform(20, [width - 20, height - 20]), rng.uniform(8, 30),
                     rng.uniform(4, 12), rng.uniform(-1, 1))
        quad[3] = quad[0]  # three distinct corners: the min-area rectangle of a triangle
        boxes.append(quad)
    return [box.astype("float32") for box in boxes]


# ---------------------------------------------------------------------------
# Geometry and grey conversion: exact
# ---------------------------------------------------------------------------


def test_get_rotated_box_and_width_height_exact():
    rng = np.random.RandomState(0)
    cases = _boxes(1, 40, (120, 160))
    cases += [rng.uniform(0, 50, size=(n, 2)) for n in (5, 9, 17)]  # point clouds
    cases += [
        np.array([[3, 4], [3, 4], [9, 4], [9, 4]], float),  # two distinct points
        np.array([[5, 5], [5, 5], [5, 5], [5, 5]], float),  # one
        np.array([[0, 7], [10, 7], [10, 7], [0, 7]], float),  # tl[1] == bl[1]: NaN -> 0
    ]
    for points in cases:
        pts, rotation = tools.get_rotated_box(points)
        ref_pts, ref_rotation = jtools.get_rotated_box(points)
        assert pts.dtype == ref_pts.dtype == np.float32
        np.testing.assert_array_equal(pts, ref_pts)
        assert rotation == ref_rotation and np.isfinite(rotation)
        assert tools.get_rotated_width_height(pts) == jtools.get_rotated_width_height(pts)


def test_get_perspective_transform_and_warp_perspective_exact():
    rng = np.random.RandomState(2)
    image = rng.randint(0, 256, size=(40, 56, 3)).astype(np.uint8)
    for box in _boxes(3, 12, image.shape):
        pts, _ = tools.get_rotated_box(box)
        dst = np.array([[0, 0], [50, 0], [50, 14], [0, 14]], "float32")
        M = tools.get_perspective_transform(pts, dst)
        np.testing.assert_array_equal(M, jtools.get_perspective_transform(pts, dst))
        for source in (image, image[..., 1], image.astype(np.float32)):
            np.testing.assert_array_equal(
                tools.warp_perspective(source, M, dsize=(50, 14)),
                jtools.warp_perspective(source, M, dsize=(50, 14)),
            )


def test_warp_perspective_edge_rule():
    """Samples exactly on the last row and column read it; a hair past
    either edge takes ``cval``, as scipy's ``mode="constant"`` does."""
    image = np.array([[10, 20, 30], [40, 50, 60]], np.uint8)
    for shift in (0.0, 1e-9, -1e-9, 0.5):
        M = np.array([[1.0, 0, -shift], [0, 1.0, -shift], [0, 0, 1.0]])
        np.testing.assert_array_equal(
            tools.warp_perspective(image, M, dsize=(3, 2), cval=7),
            jtools.warp_perspective(image, M, dsize=(3, 2), cval=7),
        )


@pytest.mark.parametrize("mode", ["letterbox", "crop"])
def test_fit_and_read_and_fit_exact(mode):
    rng = np.random.RandomState(4)
    for shape in ((31, 200, 3), (50, 120, 3), (90, 60, 3), (17, 333, 3), (200, 31, 3)):
        image = rng.randint(0, 256, size=shape).astype(np.uint8)
        for cval in (0, 255):
            out, scale = tools.fit(image, width=200, height=31, cval=cval, mode=mode,
                                   return_scale=True)
            ref, ref_scale = jtools.fit(image, width=200, height=31, cval=cval, mode=mode,
                                        return_scale=True)
            assert scale == ref_scale and out.dtype == ref.dtype
            np.testing.assert_array_equal(out, ref)
    image = jtools.read(os.path.join(GOLDEN, SCENES[0]))
    path = os.path.join(GOLDEN, SCENES[0])
    for source in (path, image):
        np.testing.assert_array_equal(
            tools.read_and_fit(source, width=200, height=31, cval=0, mode=mode),
            jtools.read_and_fit(source, width=200, height=31, cval=0, mode=mode),
        )
    with pytest.raises(NotImplementedError):
        tools.fit(image, width=20, height=20, mode="stretch")


def test_rgb_to_grayscale_host_bit_exact():
    rng = np.random.RandomState(5)
    grid = np.stack(np.meshgrid(*[np.arange(0, 256, 5)] * 3, indexing="ij"), -1).reshape(-1, 3)
    for image in (grid.astype(np.uint8), rng.randint(0, 256, size=(64, 64, 3)).astype(np.uint8)):
        out = recognition.rgb_to_grayscale_host(image)
        assert out.dtype == np.uint8
        np.testing.assert_array_equal(out, jrecognition.rgb_to_grayscale_host(image))


# ---------------------------------------------------------------------------
# Host warpBox crops
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("channels", [3, 1])
def test_warp_box_matches_jax(channels):
    """Rotated, thin, flush and repeated-corner boxes, with targets
    (31 x 200) and without: within 1 count, exact on >= 99.9% of pixels;
    a box whose width or height truncates to 0 raises in both."""
    image = np.random.RandomState(6).randint(0, 256, size=(120, 160, 3)).astype(np.uint8)
    if channels == 1:
        image = jrecognition.rgb_to_grayscale_host(image)
    total = differing = raised = 0
    for box in _boxes(7, 60, image.shape):
        for targets in ((31, 200), (None, None)):
            try:
                ref = jtools.warpBox(image, box, target_height=targets[0], target_width=targets[1])
            except ZeroDivisionError:
                raised += 1
                with pytest.raises(ZeroDivisionError):
                    tools.warpBox(image, box, target_height=targets[0], target_width=targets[1])
                continue
            out = tools.warpBox(image, box, target_height=targets[0], target_width=targets[1])
            assert out.shape == ref.shape and out.dtype == ref.dtype == np.uint8
            diff = np.abs(out.astype(np.int64) - ref)
            assert diff.max() <= 1
            total += diff.size
            differing += int((diff > 0).sum())
    assert total > 100_000 and raised < 10
    assert differing <= total * 1e-3
    out, M = tools.warpBox(image, _boxes(8, 1, image.shape)[0], 31, 200, margin=2,
                           return_transform=True, skip_rotate=True)
    ref, ref_M = jtools.warpBox(image, _boxes(8, 1, image.shape)[0], 31, 200, margin=2,
                                return_transform=True, skip_rotate=True)
    np.testing.assert_array_equal(M, ref_M)
    assert np.abs(out.astype(np.int64) - ref).max() <= 1
    with pytest.raises(ValueError):
        tools.warpBox(image, _boxes(8, 1, image.shape)[0], target_height=31)


# ---------------------------------------------------------------------------
# Recognizer and the two-stage pipeline, golden slim models
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def golden_pipelines():
    jax_pipeline, _ = jgolden.load_golden_pipeline(GOLDEN)
    port_pipeline, _ = golden.load_golden_pipeline(GOLDEN, device="cpu")
    images = [jtools.read(os.path.join(GOLDEN, scene)) for scene in SCENES]
    return jax_pipeline, port_pipeline, images


@pytest.fixture(scope="module")
def two_stage(golden_pipelines):
    """Both pipelines' two-stage results on the two scenes as one batch."""
    jax_pipeline, port_pipeline, images = golden_pipelines
    ref = jax_pipeline.recognize(images, recognition_kwargs={"verbose": 0})
    out = port_pipeline.recognize(images, recognition_kwargs={"verbose": 0})
    return ref, out


def test_two_stage_pipeline_matches_jax(golden_pipelines, two_stage):
    """Same words in the same order, every box at IoU > 0.9 (the fused
    golden parity bar), and the words the fused path reads."""
    _, port_pipeline, images = golden_pipelines
    ref, out = two_stage
    assert [[w for w, _ in r] for r in out] == [[w for w, _ in r] for r in ref]
    assert all(len(r) >= 3 for r in out)
    for got, want in zip(out, ref):
        for (_, box), (_, ref_box) in zip(got, want):
            assert box.shape == (4, 2) and box.dtype == np.float32
            assert jevaluation.iou_score(box, ref_box) > 0.9
    assert port_pipeline.last_run_stats == {k: 0 for k in port_pipeline.last_run_stats}
    fused = port_pipeline.recognize(images)
    assert [sorted(w for w, _ in r) for r in out] == [sorted(w for w, _ in r) for r in fused]


def test_recognize_from_boxes_matches_jax(golden_pipelines, two_stage):
    """The two-stage boxes on the original scenes: strings exactly equal
    to JAX per image, in chunks of 3 too; no boxes gives empty lists."""
    jax_pipeline, port_pipeline, images = golden_pipelines
    _, out = two_stage
    box_groups = [np.array([box for _, box in words]) for words in out]
    ref = jax_pipeline.recognizer.recognize_from_boxes(images, box_groups)
    got = port_pipeline.recognizer.recognize_from_boxes(images, box_groups)
    chunked = port_pipeline.recognizer.recognize_from_boxes(
        images, box_groups, batch_size=3, verbose=1
    )
    assert got == chunked == ref
    assert [len(g) for g in got] == [len(b) for b in box_groups]
    empty = [np.zeros((0, 4, 2), "float32")] * 2
    assert port_pipeline.recognizer.recognize_from_boxes(images, empty) == [[], []]
    with pytest.raises(TypeError):
        port_pipeline.recognizer.recognize_from_boxes(images, box_groups, workers=2)
    with pytest.raises(ValueError):
        port_pipeline.recognizer.recognize_from_boxes(images, box_groups[:1])


def test_recognize_single_crop_matches_jax(golden_pipelines, two_stage):
    """``Recognizer.recognize`` of uncropped word images (letterboxed on
    black, RGB turned grey), and of a path."""
    jax_pipeline, port_pipeline, images = golden_pipelines
    _, out = two_stage
    crops = [tools.warpBox(images[0], box) for _, box in out[0][:4]]
    got = [port_pipeline.recognizer.recognize(crop) for crop in crops]
    assert got == [jax_pipeline.recognizer.recognize(crop) for crop in crops]
    assert sum(bool(word) for word in got) >= 2
    path = os.path.join(GOLDEN, SCENES[1])
    assert port_pipeline.recognizer.recognize(path) == jax_pipeline.recognizer.recognize(path)


def test_two_stage_shape_policy_and_kwargs(golden_pipelines):
    """The pad_to / size_bucket policy of the fused path (pad_to in
    pre-resize space times scale, too small raises, extents rounded up to
    the bucket), and an unknown recognizer kwarg raises TypeError."""
    _, port_golden, _ = golden_pipelines
    pipeline = Pipeline(detector=port_golden.detector, recognizer=port_golden.recognizer,
                        scale=2, pad_to=(64, 96))
    seen = []
    detect = pipeline.detector.detect

    def spy(images, **kwargs):
        seen.append(np.asarray(images).shape)
        return detect(images=images, **kwargs)

    rng = np.random.RandomState(5)
    pipeline.detector.detect = spy
    try:
        for h, w in [(40, 50), (50, 70), (63, 95)]:
            image = rng.randint(0, 255, size=(h, w, 3), dtype="uint8")
            result = pipeline.recognize([image], recognition_kwargs={"batch_size": 4})
            assert len(result) == 1
        assert seen == [(1, 128, 192, 3)] * 3
        pipeline.pad_to = (8, 8)
        with pytest.raises(ValueError):
            pipeline.recognize([rng.randint(0, 255, size=(64, 80, 3), dtype="uint8")],
                               recognition_kwargs={"batch_size": 4})
        pipeline.pad_to = None
        seen.clear()
        pipeline.recognize([rng.randint(0, 255, size=(40, 50, 3), dtype="uint8")],
                           recognition_kwargs={"batch_size": 4})
        assert seen == [(1, 96, 128, 3)]
    finally:
        del pipeline.detector.detect
    with pytest.raises(TypeError):
        pipeline.recognize([np.zeros((32, 32, 3), np.uint8)],
                           recognition_kwargs={"nonsense_option": 1})


def test_recognizer_positional_order_and_device():
    """``(alphabet, weights, build_params)`` as in JAX; ``device`` and
    ``seed`` keyword-only."""
    params = dict(jrecognition.DEFAULT_BUILD_PARAMS, filters=(4,) * 7, rnn_units=(4, 4),
                  stn=False)
    recognizer = Recognizer("abc", None, params, device="cpu")
    assert recognizer.alphabet == "abc" and recognizer.input_shape == (31, 200, 1)
    assert recognizer.device == torch.device("cpu")
    with pytest.raises(TypeError):
        Recognizer("abc", None, params, "cpu")
    with pytest.raises(NotImplementedError):
        Recognizer("abc", "kurapan", device="cpu")
