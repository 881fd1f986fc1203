"""Spatial sharding of an EfficientNet CRAFT (``parallel/halo.py``,
``models/efficientnet.py``): ``Pipeline(mesh=...)`` with a ``model`` axis of
several devices runs the B0 backbone on row strips, on fake CPU devices.

- a strided TF "SAME" conv (the stem's 3x3, a 3x3 and a 5x5 depthwise) and
  a 5x5 stride-1 depthwise on strips, with the whole image's pads at its
  top and bottom only, against the whole conv, bit for bit (integer
  values in float64), at an even and an odd height;
- the squeeze-excite mean as a sum over the strips, one of them empty,
  against the whole mean;
- the B0 strip forward against the whole one: the four taps and the
  heatmaps within 1e-4 x max(1, max|ref|) in float32 (PARITY.md), the
  heatmaps within the bf16 bars of PERF.md §2 (max 8e-3 x max(1,
  max|ref|), mean 1e-3) in bfloat16; heights 136 (taps 68 / 34 / 17 / 9)
  and 64 (4 strips of 16 rows, and 8 strips, some empty);
- the port's strips on the 4x2 mesh shape against JAX's B0 CRAFT jitted
  with its input under ``spatial_sharding`` of a (4, 2) mesh of the 8 fake
  CPU devices, within 1e-4 x max(1, max|ref|);
- ``Pipeline(b0, recognizer, mesh=...)`` on the 4x2 and hybrid 2x2x2
  meshes (and in bfloat16 on 1x2) against the unsharded pipeline: the same
  words, boxes within 1e-4; the two-stage ``detect`` on the first data
  position's strips too.

One seeded B0 tree (BatchNorm parameters and statistics drawn from a seed,
as ``tests/test_torch_efficientnet.py`` draws them) serves every case.
"""

import string
import urllib.request

import jax
import numpy as np
import pytest
import torch

from keras_ocr_tpu.models.craft import CRAFT as JaxCRAFT
from keras_ocr_tpu.parallel import mesh as jmesh
from keras_ocr_tpu_torch import Detector, Pipeline, Recognizer, parallel, weights
from keras_ocr_tpu_torch.models import CRAFT, init_parameters
from keras_ocr_tpu_torch.models.efficientnet import SameConv2d
from keras_ocr_tpu_torch.parallel import halo
from keras_ocr_tpu_torch.parallel import mesh as mesh_lib

torch.set_num_threads(2)

CPU = torch.device("cpu")
B0 = "efficientnetb0"
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
}
BF16_BARS = (8e-3, 1e-3)


def _strips(fn, x, parts, dim):
    """``fn`` on the strips of ``x`` at ``strip_bounds`` in one strip group
    (empty strips left out, as ``StripForward`` leaves them); each output
    (or each entry of a tuple output) gathered along ``dim``."""
    bounds = mesh_lib.strip_bounds(x.shape[dim], parts)
    spans = [(lo, hi) for lo, hi in zip(bounds, bounds[1:]) if hi > lo]
    outs = halo.StripGroup(len(spans)).run(
        lambda rank: fn(x.narrow(dim, spans[rank][0], spans[rank][1] - spans[rank][0])))
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts, dim) for parts in zip(*outs))
    return torch.cat(outs, dim)


@pytest.mark.parametrize("parts", [2, 4])
@pytest.mark.parametrize("height", [136, 135], ids=["even", "odd"])
@pytest.mark.parametrize("conv", ["stem 3x3 s2", "depthwise 3x3 s2", "depthwise 5x5 s2",
                                  "depthwise 5x5 s1"])
def test_same_conv_on_strips_pads_at_the_image_edges(conv, height, parts):
    """Each strip's output rows of a "SAME" conv equal the whole conv's:
    the strided conv's pads come from the whole height (an odd one pads 1
    row above a 3x3 and 2 above a 5x5, an even one 0 and 1), at the image's
    top and bottom only, with the rows an inner edge reads taken from the
    neighbouring strips. Integer values in float64: every order of the sums
    gives the same value."""
    kind, size, stride = conv.split()
    kernel, stride = int(size[0]), int(stride[1])
    channels = 3 if kind == "stem" else 6
    module = SameConv2d(channels, 8 if kind == "stem" else channels, kernel, stride,
                        groups=1 if kind == "stem" else channels).double()
    rng = np.random.RandomState(height + kernel)
    with torch.no_grad():
        module.weight.copy_(torch.from_numpy(rng.randint(-3, 4, module.weight.shape)))
    x = torch.from_numpy(rng.randint(-9, 10, (2, channels, height, 11)).astype(np.float64))
    with torch.no_grad():
        whole = module(x)
        out = _strips(module, x, parts, dim=2)
    assert whole.shape[2] == -(-height // stride)
    assert torch.equal(out, whole)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bf16"])
def test_squeeze_excite_mean_is_a_sum_over_the_strips(dtype):
    """``halo.mean`` on strips of 0, 5, 16 and 3 rows of (2, 7, 24, 9)
    values: every strip, the empty one too, gets the whole image's mean
    (float32 sums divided by 24 x 9, rounded once), equal to the mean of
    the whole tensor; outside a strip forward it is ``x.mean``."""
    rng = np.random.RandomState(7)
    x = torch.from_numpy(rng.randn(2, 7, 24, 9).astype(np.float32)).to(dtype)
    ref = x.mean((2, 3), keepdim=True)
    assert torch.equal(halo.mean(x, (2, 3), dim=2), ref)
    spans = [(0, 0), (0, 5), (5, 21), (21, 24)]
    means = halo.StripGroup(len(spans)).run(
        lambda rank: halo.mean(x[:, :, spans[rank][0]:spans[rank][1]], (2, 3), dim=2))
    exact = x.double().mean((2, 3), keepdim=True)
    for got in means:
        assert got.dtype == dtype and got.shape == ref.shape
        assert torch.equal(got, means[0])
        if dtype == torch.float32:
            torch.testing.assert_close(got, ref, rtol=0, atol=1e-6)
        else:
            assert torch.equal(got, exact.to(dtype))


def _seeded_tree():
    """The B0 CRAFT tree with BatchNorm parameters and statistics drawn
    from a seed (scale and variance in [0.5, 1.5), shift and mean +-0.1)."""
    tree = weights.craft_variables(init_parameters(CRAFT(B0), seed=0))
    rng = np.random.RandomState(0)

    def fill(params, stats):
        for child, node in params.items():
            if "scale" in node:
                node["scale"] = rng.uniform(0.5, 1.5, node["scale"].shape).astype(np.float32)
                node["bias"] = rng.uniform(-0.1, 0.1, node["bias"].shape).astype(np.float32)
                stats[child] = {
                    "mean": rng.uniform(-0.1, 0.1, node["bias"].shape).astype(np.float32),
                    "var": rng.uniform(0.5, 1.5, node["bias"].shape).astype(np.float32)}
            elif "kernel" not in node:
                fill(node, stats[child])

    fill(tree["params"], tree["batch_stats"])
    return tree


@pytest.fixture(scope="module")
def tree():
    return _seeded_tree()


@pytest.fixture(scope="module")
def detectors(tree, tmp_path_factory):
    """The B0 detector in float32 and in bfloat16, built offline (the
    ImageNet file is missing: it warns), both loaded with ``tree``."""
    root = tmp_path_factory.mktemp("offline")
    with pytest.MonkeyPatch.context() as patch:
        def refuse(*args, **kwargs):
            raise OSError("no network in the tests")

        patch.setattr(urllib.request, "urlopen", refuse)
        patch.setenv("KERAS_OCR_TPU_VENDORED_WEIGHTS", str(root / "vendored"))
        patch.setenv("KERAS_OCR_TPU_CACHE_DIR", str(root / "cache"))
        patch.delenv("KERAS_OCR_TPU_WEIGHTS_MIRROR", raising=False)
        made = {}
        for dtype in (torch.float32, torch.bfloat16):
            with pytest.warns(UserWarning, match="ImageNet"):
                made[dtype] = Detector(weights=None, backbone_name=B0, compute_dtype=dtype,
                                       max_components=16, device="cpu")
            made[dtype].load_variables(tree)
    return made


def _assert_within(out, ref, dtype, what="heatmaps"):
    assert out.shape == ref.shape, what
    scale = max(1.0, float(ref.abs().max()))
    err = (out.float() - ref.float()).abs()
    if dtype == torch.float32:
        assert float(err.max()) <= 1e-4 * scale, (what, float(err.max()))
    else:
        assert float(err.max()) <= BF16_BARS[0] * scale, (what, float(err.max()))
        assert float(err.mean()) <= BF16_BARS[1], (what, float(err.mean()))


@pytest.mark.parametrize("shape,parts", [((1, 136, 72), 2), ((2, 64, 48), 4),
                                         ((1, 64, 48), 8)],
                         ids=["136 on 2", "64 on 4", "64 on 8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bf16"])
def test_b0_strip_forward_matches_the_whole_forward(detectors, dtype, shape, parts):
    """The B0 CRAFT's heatmaps on strips equal the whole forward's, and in
    float32 so do the backbone's four taps (at H/2 .. H/16: 68 / 34 / 17 /
    9 rows at height 136, whose last strip keeps the odd remainders). At
    height 64 on 8 strips, 4 strips are empty."""
    model = detectors[dtype].model
    x = torch.from_numpy(np.random.RandomState(sum(shape)).randn(*shape, 3).astype(np.float32))
    with torch.inference_mode():
        ref = model(x)
        out = halo.StripForward([CPU] * parts)([model] * parts, x)
        assert out.dtype == torch.float32
        _assert_within(out, ref, dtype)
        if dtype == torch.float32:
            nchw = x.permute(0, 3, 1, 2).contiguous()
            taps = model.basenet(nchw)
            strip_taps = _strips(model.basenet, nchw, parts, dim=2)
            for k, (tap, ref_tap) in enumerate(zip(strip_taps, taps), start=1):
                assert ref_tap.shape[2] == -(-shape[1] // 2**k)
                _assert_within(tap, ref_tap, dtype, f"tap s{k}")


def test_b0_strips_match_jax_spatial_sharding(detectors, tree):
    """JAX's B0 CRAFT jitted with the input under ``spatial_sharding`` of a
    (4, 2) mesh of 8 fake CPU devices, against the port's strips on the
    same mesh shape (one strip forward a data position), the variables
    carried across by ``Detector.load_variables``, within 1e-4."""
    jax_mesh = jmesh.create_mesh(shape=(4, 2))
    sharding = jmesh.spatial_sharding(jax_mesh)
    forward = jax.jit(lambda v, x: JaxCRAFT(backbone_name=B0).apply(
        v, jax.lax.with_sharding_constraint(x, sharding)))
    x = np.random.RandomState(4).randn(4, 64, 96, 3).astype(np.float32)
    ref = np.asarray(forward(tree, x))
    model = detectors[torch.float32].model
    rows = mesh_lib.data_rows(MESHES["4x2"]())
    with torch.inference_mode():
        out = torch.cat([halo.StripForward(row)([model] * len(row), shard)
                         for row, shard in zip(rows, torch.from_numpy(x).chunk(len(rows)))])
    assert out.shape == ref.shape == (4, 32, 48, 2)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                               atol=1e-4 * max(1.0, float(np.abs(ref).max())))


def _images(height=64, width=96, count=3, seed=1):
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


def _assert_same(results, reference):
    assert len(results) == len(reference)
    for got, want in zip(results, reference):
        assert [w for w, _ in got] == [w for w, _ in want] and got
        for (_, box), (_, ref) in zip(got, want):
            np.testing.assert_allclose(box, ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize("mesh,dtype", [("4x2", torch.float32),
                                        ("hybrid_2x2x2", torch.float32),
                                        ("1x2", torch.bfloat16)],
                         ids=["4x2", "hybrid_2x2x2", "1x2 bf16"])
def test_b0_pipeline_on_strips_matches_unsharded(detectors, recognizer, mesh, dtype):
    """``Pipeline(b0, recognizer, mesh=...)`` reads the unsharded
    pipeline's words and boxes, through ``recognize`` and through the
    two-stage path, whose ``detect`` runs on the first data position's
    strips."""
    detector = detectors[dtype]
    images = _images()
    plain = Pipeline(detector, recognizer, 2, 2048, 8)
    sharded = Pipeline(detector, recognizer, 2, 2048, 8, 32, None, MESHES[mesh]())
    assert all(strips is not None for strips in sharded._strips)
    assert len(sharded._strips) == mesh_lib.data_size(sharded.mesh)
    _assert_same(sharded.recognize(images, detection_kwargs=DETECTION_KWARGS),
                 plain.recognize(images, detection_kwargs=DETECTION_KWARGS))
    two_stage = {"batch_size": 4}
    _assert_same(sharded.recognize(images[:2], DETECTION_KWARGS, two_stage),
                 plain.recognize(images[:2], DETECTION_KWARGS, two_stage))
