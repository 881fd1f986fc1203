"""Spatial sharding of the port (``parallel/halo.py``): ``Pipeline(mesh=...)``
with a ``model`` axis of several devices runs CRAFT on row strips of the
images with halo exchanges between them, on fake CPU devices.

- the strip bounds, a halo wider than the strips, and the strip resize
  against the whole-image resize, bit for bit;
- the strip CRAFT forward against the whole one: float32 standard and
  folded within 1e-4 x max(1, max|ref|) (PARITY.md), bfloat16 within the
  bf16 bars of PERF.md §2 (max 8e-3 x max(1, max|ref|), mean 1e-3);
- the sharded pipeline against the unsharded one (the VGG detector at
  width 0.25, ``max_components=16``; ``tests/test_pipeline.py:177``'s
  images and thresholds): the same words, boxes within 1e-4, on the 4x2
  and hybrid 2x2x2 meshes, at a height that is not a multiple of 32 and
  with strips shorter than the dilated conv's halo; the folded graph and
  bfloat16; ``recognize_many`` and the two-stage path;
- the strip forward against the JAX package's spatially sharded forward
  (``with_sharding_constraint(x, spatial_sharding(mesh))``) on its 8 fake
  CPU devices, within 1e-4.
"""

import string

import jax
import numpy as np
import pytest
import torch

from keras_ocr_tpu.detection import Detector as JaxDetector
from keras_ocr_tpu.parallel import mesh as jmesh
from keras_ocr_tpu_torch import Detector, Pipeline, Recognizer, parallel
from keras_ocr_tpu_torch.models.craft import fold_bn_state_dict
from keras_ocr_tpu_torch.ops import image as image_ops
from keras_ocr_tpu_torch.parallel import halo
from keras_ocr_tpu_torch.parallel import mesh as mesh_lib

torch.set_num_threads(2)

CPU = torch.device("cpu")
ALPHABET = string.digits + string.ascii_lowercase
SLIM_CRNN = {
    "height": 31, "width": 200, "color": False, "filters": (8,) * 7, "rnn_units": (8, 8),
    "dropout": 0.0, "rnn_steps_to_discard": 2, "pool_size": 2, "stn": False,
}
DETECTION_KWARGS = {"detection_threshold": -10.0, "text_threshold": -10.0,
                    "link_threshold": 10.0, "size_threshold": 1}
MESHES = {
    "4x2": lambda: parallel.create_mesh((4, 2), devices=[CPU] * 8),
    "hybrid_2x2x2": lambda: parallel.create_hybrid_mesh(2, (2, 2), devices=[CPU] * 8),
    "1x2": lambda: parallel.create_mesh((1, 2), devices=[CPU] * 2),
    "2x4": lambda: parallel.create_mesh((2, 4), devices=[CPU] * 8),
}


@pytest.mark.parametrize("height,parts,bounds", [
    (128, 2, [0, 64, 128]), (136, 2, [0, 64, 136]), (128, 4, [0, 32, 64, 96, 128]),
    (40, 4, [0, 0, 16, 16, 40]), (8, 2, [0, 0, 8]),
])
def test_strip_bounds(height, parts, bounds):
    """Inner bounds on multiples of 16, the last strip takes the remainder,
    a short image leaves strips empty."""
    assert parallel.strip_bounds(height, parts) == bounds


def _run_strips(fn, x, parts, dim=1):
    """``fn`` on the strips of ``x`` at ``strip_bounds``, gathered."""
    bounds = mesh_lib.strip_bounds(x.shape[dim], parts)
    spans = [(lo, hi) for lo, hi in zip(bounds, bounds[1:]) if hi > lo]
    group = halo.StripGroup(len(spans))
    outs = group.run(lambda rank: fn(x.narrow(dim, spans[rank][0],
                                             spans[rank][1] - spans[rank][0])))
    return torch.cat(outs, dim)


@pytest.mark.parametrize("rows,parts", [(1, 4), (3, 8), (7, 8)])
def test_halo_reaches_past_short_neighbours(rows, parts):
    """A SAME box filter of half-width ``rows`` on the strips of a 128-row
    column subsampled 8x (2 rows a strip on 8 strips, fewer than the
    halo): equal to the filter of the whole subsampled column."""

    def box(t):
        padded = torch.nn.functional.pad(t[None, None], (rows, rows))[0, 0]
        return torch.stack([padded[i : i + t.shape[0]] for i in range(2 * rows + 1)]).sum(0)

    # Integers: every order of the sums gives the same value.
    x = torch.from_numpy(np.random.RandomState(rows).randint(-99, 99, 128).astype(np.float32))
    whole = box(x[::8])
    out = _run_strips(lambda t: halo.apply(box, t[::8], rows, dim=0), x, parts, dim=0)
    assert torch.equal(out, whole)
    assert torch.equal(halo.apply(box, x, rows, dim=0), box(x))  # no strips: fn(x)


@pytest.mark.parametrize("failing", [0, 1, 2])
def test_strip_group_takes_turns_and_raises_without_hanging(failing):
    """The strips run one at a time in rank order between meetings; a rank
    that raises (before its first meeting or after it) ends the run with
    its own error, and the group runs again afterwards."""
    group = halo.StripGroup(3)
    order = []

    def fn(rank):
        order.append(rank)
        values = group.gather(rank, rank * 10)
        if rank == failing:
            raise ValueError(f"rank {rank}")
        order.append(rank)
        return values, group.gather(rank, -rank)

    with pytest.raises(ValueError, match=f"rank {failing}"):
        group.run(fn)
    order.clear()
    results = group.run(lambda rank: (order.append(rank), group.gather(rank, rank),
                                      order.append(rank), group.gather(rank, 2 * rank))[1::2])
    assert order == [0, 1, 2, 0, 1, 2]
    assert results == [([0, 1, 2], [0, 2, 4])] * 3


@pytest.mark.parametrize("in_height,height,parts", [(8, 16, 2), (8, 17, 2), (17, 34, 4),
                                                    (4, 9, 4), (34, 68, 3)])
def test_strip_resize_is_the_whole_resize(in_height, height, parts):
    """A decoder step's input on strips (the resize and the skip, with and
    without a halo row): each strip's rows of the resize, from its
    neighbours' rows where the half-pixel taps reach them, equal the whole
    resize bit for bit (the exact 2x path and the general one)."""
    rng = np.random.RandomState(height)
    y = torch.from_numpy(rng.randn(2, in_height, 5, 3).astype(np.float32))
    skip = torch.from_numpy(rng.randn(2, height, 10, 1).astype(np.float32))
    whole = image_ops.resize_bilinear(y, height, 10)
    y_bounds = np.linspace(0, in_height, parts + 1).astype(int)
    s_bounds = np.linspace(0, height, parts + 1).astype(int)
    group = halo.StripGroup(parts)
    for rows in (0, 1):
        outs = group.run(lambda k: halo.apply_upsampled(
            lambda t: t, y[:, y_bounds[k]:y_bounds[k + 1]], skip[:, s_bounds[k]:s_bounds[k + 1]],
            rows))
        assert torch.equal(torch.cat(outs, 1), torch.cat([whole, skip], -1))


def _seeded_statistics(model, seed):
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, torch.nn.BatchNorm2d):
                n = module.num_features
                module.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, n)))
                module.bias.copy_(torch.from_numpy(rng.uniform(-0.1, 0.1, n)))
                module.running_mean.copy_(torch.from_numpy(rng.uniform(-0.1, 0.1, n)))
                module.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 2.0, n)))


def _detector(fold_bn=False, dtype=torch.float32):
    """The width-0.25 VGG detector with seeded BatchNorm statistics (seed
    0 weights), folded or not, in ``dtype``."""
    standard = Detector(weights=None, width=0.25, max_components=16, device="cpu")
    _seeded_statistics(standard.model, 3)
    detector = Detector(weights=None, compute_dtype=dtype, max_components=16, fold_bn=fold_bn,
                        width=0.25, device="cpu")
    state = standard.model.state_dict()
    detector.model.load_state_dict(fold_bn_state_dict(state) if fold_bn else state)
    return detector


def _assert_within(out, ref, dtype):
    scale = max(1.0, float(ref.abs().max()))
    err = (out - ref).abs()
    if dtype == torch.float32:
        assert float(err.max()) <= 1e-4 * scale, float(err.max())
    else:
        assert float(err.max()) <= 8e-3 * scale and float(err.mean()) <= 1e-3


GRAPHS = {"standard": (False, torch.float32), "folded": (True, torch.float32),
          "bf16": (False, torch.bfloat16), "folded bf16": (True, torch.bfloat16)}


@pytest.fixture(scope="module")
def detectors():
    """One detector a graph, shared by the file's cases (inference only)."""
    return {graph: _detector(*GRAPHS[graph]) for graph in GRAPHS}


@pytest.mark.parametrize("graph,shape,parts", [
    *((graph, (2, 128, 96), 2) for graph in GRAPHS),
    ("standard", (1, 136, 72), 2),
    ("folded bf16", (1, 128, 64), 4),
    ("folded", (1, 72, 104), 3),
])
def test_strip_forward_matches_the_whole_forward(detectors, graph, shape, parts):
    """Every graph on 2 strips; each edge case once: (1, 136, 72) the
    decoder's non-2x resize (8 -> 17 rows); (1, 128, 64) on 4 strips, 2
    rows each at 1/16 under a 7-row s5 halo; (1, 72, 104) on 3 strips, one
    empty and an odd pool in the last."""
    dtype = GRAPHS[graph][1]
    model = detectors[graph].model
    x = torch.from_numpy(np.random.RandomState(sum(shape)).randn(*shape, 3).astype(np.float32))
    with torch.inference_mode():
        ref = model(x)
        out = halo.StripForward([CPU] * parts)([model] * parts, x)
    assert out.shape == ref.shape and out.dtype == torch.float32
    _assert_within(out, ref, dtype)


def _images(height=64, width=96, count=2, seed=1):
    """``tests/test_pipeline.py``'s spatial-sharding images."""
    rng = np.random.RandomState(seed)
    images = []
    for _ in range(count):
        image = np.zeros((height, width, 3), dtype="uint8")
        x, y = rng.randint(0, width - 56), rng.randint(0, height - 34)
        image[y : y + 20, x : x + 50] = 255
        images.append(image)
    return images


@pytest.fixture(scope="module")
def recognizer():
    return Recognizer(ALPHABET, None, SLIM_CRNN, device="cpu")


@pytest.fixture(scope="module")
def unsharded(detectors, recognizer):
    """``read(graph, size, bucket)``: the unsharded pipeline's reading of
    ``_images(*size)``, made once for the file's cases."""
    readings = {}

    def read(graph, size=(64, 96), bucket=32):
        if (graph, size, bucket) not in readings:
            plain = Pipeline(detectors[graph], recognizer, 2, 2048, 8, bucket)
            readings[graph, size, bucket] = plain.recognize(_images(*size),
                                                            detection_kwargs=DETECTION_KWARGS)
        return readings[graph, size, bucket]

    return read


def _assert_same(results, reference):
    assert len(results) == len(reference)
    for got, want in zip(results, reference):
        assert [w for w, _ in got] == [w for w, _ in want] and got
        for (_, box), (_, ref) in zip(got, want):
            np.testing.assert_allclose(box, ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize("mesh,size,bucket", [
    ("4x2", (64, 96), 32),  # the JAX test's 128x192 input
    ("hybrid_2x2x2", (64, 96), 32),
    ("1x2", (68, 100), 4),  # 136x200: not a multiple of 32
    ("2x4", (64, 96), 32),  # 32-row strips: 2 rows at 1/16 under the s5 halo
])
def test_spatial_pipeline_matches_unsharded(detectors, recognizer, unsharded, mesh, size,
                                            bucket):
    images = _images(*size)
    sharded = Pipeline(detectors["standard"], recognizer, 2, 2048, 8, bucket, None,
                       MESHES[mesh]())
    batch, _, _, resize_to = sharded._prepare(images)
    assert resize_to == (2 * size[0], 2 * size[1])
    assert len(batch) == len(sharded._strips) == mesh_lib.data_size(sharded.mesh)
    _assert_same(sharded.recognize(images, detection_kwargs=DETECTION_KWARGS),
                 unsharded("standard", size, bucket))


@pytest.mark.parametrize("graph", ["folded", "bf16"])
def test_spatial_pipeline_folded_and_bf16(detectors, recognizer, unsharded, graph):
    sharded = Pipeline(detectors[graph], recognizer, 2, 2048, 8, 32, None, MESHES["1x2"]())
    _assert_same(sharded.recognize(_images(), detection_kwargs=DETECTION_KWARGS),
                 unsharded(graph))


def test_spatial_recognize_many_and_two_stage(detectors, recognizer):
    """``recognize_many`` (2 batches, one short) and the two-stage path,
    whose ``Detector.detect`` runs on the first data position's strips."""
    detector = detectors["standard"]
    images = _images(count=3, seed=2)
    plain = Pipeline(detector, recognizer, 2, 2048, 8)
    sharded = Pipeline(detector, recognizer, 2, 2048, 8, 32, None, MESHES["1x2"]())
    _assert_same(sharded.recognize_many(images, batch_size=2, detection_kwargs=DETECTION_KWARGS),
                 plain.recognize(images, detection_kwargs=DETECTION_KWARGS))
    two_stage = {"batch_size": 4}
    _assert_same(sharded.recognize(images[:2], DETECTION_KWARGS, two_stage),
                 plain.recognize(images[:2], DETECTION_KWARGS, two_stage))


def test_strip_forward_matches_jax_spatial_sharding():
    """JAX's CRAFT jitted with the input under ``spatial_sharding`` of a
    (4, 2) mesh of 8 fake CPU devices, against the port's strips on the
    same mesh shape (one strip forward a data position), within 1e-4."""
    jax_detector = JaxDetector(weights=None, width=0.25, max_components=16)
    variables = jax.tree.map(np.asarray, jax_detector.variables)
    jax_mesh = jmesh.create_mesh(shape=(4, 2))
    sharding = jmesh.spatial_sharding(jax_mesh)
    forward = jax.jit(lambda v, x: jax_detector.model.apply(
        v, jax.lax.with_sharding_constraint(x, sharding), train=False))
    x = np.random.RandomState(4).randn(4, 64, 96, 3).astype(np.float32)
    ref = np.asarray(forward(variables, x))
    detector = Detector(weights=None, width=0.25, max_components=16, device="cpu")
    detector.load_variables(variables)
    rows = mesh_lib.data_rows(MESHES["4x2"]())
    with torch.inference_mode():
        out = torch.cat([halo.StripForward(row)([detector.model] * len(row), shard)
                         for row, shard in zip(rows, torch.from_numpy(x).chunk(len(rows)))])
    assert out.shape == ref.shape == (4, 32, 48, 2)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                               atol=1e-4 * max(1.0, float(np.abs(ref).max())))
