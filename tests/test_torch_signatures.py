"""The facades' positional order against the JAX package's: ``Detector``
takes ``compute_dtype`` fifth, ``Recognizer`` fourth and
``detection.build_model`` third, with ``device`` and ``seed`` keyword-only
in the port; the golden utility's ``load_golden_pipeline`` and
``run_golden_check`` take ``compute_dtype`` second and ``pipeline`` third,
as JAX's do. A call in JAX's positional order builds the same
configuration in both packages, in float32 and in bfloat16 (float32
parameters either way); another dtype raises ``NotImplementedError`` and a
value that is not a dtype ``TypeError``. Also the names JAX's modules
bind that the port lacked (the package's submodules, ``utils``'s
re-exports, ``golden.artifact_available``, ``detection``'s aliases) and the
TPU-only parameters in JAX's positions (``word_chunk``, ``tile_h``,
``interpret``, ``out_dtype``), and the synthetic-data and drawing functions
(``data_generation.draw_text_image`` and the rest, ``tools.drawBoxes``,
``drawAnnotations``) with JAX's signatures.
"""

import inspect
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keras_ocr_tpu import detection as jdetection
from keras_ocr_tpu.detection import Detector as JaxDetector
from keras_ocr_tpu.recognition import DEFAULT_BUILD_PARAMS
from keras_ocr_tpu.recognition import Recognizer as JaxRecognizer
from keras_ocr_tpu.utils import golden as jgolden
from keras_ocr_tpu_torch import Detector, Recognizer, detection, weights
from keras_ocr_tpu_torch.utils import golden

torch.set_num_threads(2)

SLIM_CRNN = dict(DEFAULT_BUILD_PARAMS, filters=(4,) * 7, rnn_units=(4, 4), stn=False)


def _positional(fn):
    return [p.name for p in inspect.signature(fn).parameters.values()
            if p.kind is inspect.Parameter.POSITIONAL_OR_KEYWORD]


def _shapes(tree):
    return {path: tuple(np.shape(leaf)) for path, leaf in _leaves(tree)}


def _leaves(tree, prefix=""):
    for key, value in sorted(tree.items()):
        if isinstance(value, dict):
            yield from _leaves(value, f"{prefix}{key}/")
        else:
            yield f"{prefix}{key}", value


@pytest.mark.parametrize("fold_bn", [False, True], ids=["standard", "folded"])
def test_detector_positional_order(fold_bn):
    """(weights, load_from_torch, optimizer, backbone_name, compute_dtype,
    max_components, allow_random_fallback, fold_bn, width)."""
    args = (None, False, "adam", "vgg")
    tail = (16, False, fold_bn, 0.25)
    theirs = JaxDetector(*args, jnp.float32, *tail)
    ours = Detector(*args, torch.float32, *tail, device="cpu")
    for name in ("backbone_name", "optimizer_name", "max_components", "fold_bn", "width"):
        assert getattr(ours, name) == getattr(theirs, name), name
    assert _shapes(weights.craft_variables(ours.model)) == _shapes(theirs.variables)


def test_recognizer_positional_order():
    """(alphabet, weights, build_params, compute_dtype)."""
    theirs = JaxRecognizer("abc", None, SLIM_CRNN, jnp.float32)
    ours = Recognizer("abc", None, SLIM_CRNN, torch.float32, device="cpu")
    assert ours.alphabet == theirs.alphabet
    assert ours.build_params == theirs.build_params
    assert ours.input_shape == theirs.input_shape
    assert _shapes(weights.crnn_variables(ours.model)) == _shapes(theirs.variables)
    with pytest.raises(TypeError):  # device is keyword-only
        Recognizer("abc", None, SLIM_CRNN, torch.float32, "cpu")


def test_build_model_positional_order():
    """(backbone_name, weights_path, compute_dtype); seed is keyword-only."""
    theirs_model, theirs = jdetection.build_model("vgg", None, jnp.float32)
    model, ours = detection.build_model("vgg", None, torch.float32, seed=3)
    assert theirs_model.backbone_name == model.backbone_name == "vgg"
    assert _shapes(ours) == _shapes(theirs)
    with pytest.raises(TypeError):
        detection.build_model("vgg", None, torch.float32, 3)


def _model(built):
    """The CRAFT / CRNN module of a facade or of ``build_model``'s pair."""
    return built[0] if isinstance(built, tuple) else built.model


@pytest.mark.parametrize("entry", ["Detector", "Recognizer", "build_model"])
def test_only_float32_is_ported(entry):
    """Only the JAX package's two compute dtypes are ported: float32 and,
    since the bfloat16 slice, bfloat16 in JAX's position (the JAX facade's
    ``compute_dtype`` position), which builds a bf16 module with float32
    parameters as the JAX facade does; float16 is still refused."""
    build = {
        "Detector": lambda dtype: Detector(None, False, "adam", "vgg", dtype, width=0.125,
                                           device="cpu"),
        "Recognizer": lambda dtype: Recognizer("abc", None, SLIM_CRNN, dtype, device="cpu"),
        "build_model": lambda dtype: detection.build_model("vgg", None, dtype),
    }[entry]
    jax_entry, ours_entry = {
        "Detector": (JaxDetector, Detector),
        "Recognizer": (JaxRecognizer, Recognizer),
        "build_model": (jdetection.build_model, detection.build_model),
    }[entry]
    position = list(inspect.signature(jax_entry).parameters).index("compute_dtype")
    assert list(inspect.signature(ours_entry).parameters).index("compute_dtype") == position
    ours = _model(build(torch.bfloat16))
    assert ours.dtype == torch.bfloat16
    assert {p.dtype for p in ours.parameters()} == {torch.float32}
    assert _model(build(torch.float32)).dtype == torch.float32
    with pytest.raises(NotImplementedError, match="float32 or bfloat16"):
        build(torch.float16)
    with pytest.raises(TypeError, match="torch.dtype"):
        build("cpu")


@pytest.mark.parametrize("name", ["load_golden_pipeline", "run_golden_check"])
def test_golden_utility_positional_order(name):
    """The port's positional parameters are the JAX function's, in order;
    the port's own options (``device``, ``fold_bn``) are keyword-only."""
    def positional(fn):
        return [p.name for p in inspect.signature(fn).parameters.values()
                if p.kind is inspect.Parameter.POSITIONAL_OR_KEYWORD]

    ours, theirs = getattr(golden, name), getattr(jgolden, name)
    assert positional(ours) == positional(theirs)
    extra = set(inspect.signature(ours).parameters) - set(inspect.signature(theirs).parameters)
    assert all(inspect.signature(ours).parameters[p].kind is inspect.Parameter.KEYWORD_ONLY
               for p in extra)


def test_run_golden_check_uses_a_pipeline_passed_in_jax_order():
    """``run_golden_check(dir, None, pipeline)`` scores the given pipeline
    (a stand-in that reads nothing) on every scene."""
    class Reader:
        last_run_stats = {"relaunches": 0}

        def __init__(self):
            self.calls = 0

        def recognize(self, images):
            self.calls += 1
            return [[]]

    reader = Reader()
    artifact = os.path.join(os.path.dirname(__file__), "fixtures", "golden_offline")
    result = golden.run_golden_check(artifact, None, reader)
    assert reader.calls == result["n_scenes"] > 0
    assert result["fraction"] == 0.0 and not result["pass"]


def test_pipeline_positional_order():
    """(detector, recognizer, scale, max_size, max_words, size_bucket,
    pad_to, mesh, word_buckets): a JAX-order positional call binds
    ``word_buckets`` ninth in both packages, ``mesh`` eighth."""
    from keras_ocr_tpu.pipeline import Pipeline as JaxPipeline
    from keras_ocr_tpu_torch import Pipeline, parallel

    assert _positional(Pipeline.__init__) == _positional(JaxPipeline.__init__)
    assert _positional(Pipeline.__init__).index("mesh") == 8  # after self
    detector = Detector(None, width=0.125, max_components=16, device="cpu")
    recognizer = Recognizer("abc", None, SLIM_CRNN, device="cpu")
    ours = Pipeline(detector, recognizer, 2, 2048, 64, 32, None, None, (16, 64))
    assert ours.word_buckets == (16, 64) and ours.mesh is None
    mesh = parallel.create_mesh(devices=[torch.device("cpu")] * 2)
    ours = Pipeline(detector, recognizer, 2, 2048, 64, 32, None, mesh, (8, 64))
    assert ours.mesh is mesh and ours.word_buckets == (8, 64)


@pytest.mark.parametrize("name", ["config", "ops", "models", "weights", "utils"])
def test_package_binds_the_jax_submodules(name):
    import keras_ocr_tpu
    import keras_ocr_tpu_torch

    assert hasattr(keras_ocr_tpu, name)
    assert getattr(keras_ocr_tpu_torch, name).__name__ == f"keras_ocr_tpu_torch.{name}"


def test_utils_reexports_profiling():
    from keras_ocr_tpu import utils as jutils
    from keras_ocr_tpu_torch import utils
    from keras_ocr_tpu_torch.utils import profiling

    for name in ("StageTimer", "trace", "annotate"):
        assert hasattr(jutils, name) and getattr(utils, name) is getattr(profiling, name)
    assert hasattr(jutils, "profiling") and utils.profiling is profiling


def test_artifact_available(tmp_path):
    artifact = os.path.join(os.path.dirname(__file__), "fixtures", "golden_offline")
    for path in (artifact, str(tmp_path)):
        assert golden.artifact_available(path) == jgolden.artifact_available(path)
    assert golden.artifact_available(artifact) and not golden.artifact_available(str(tmp_path))


def test_detection_aliases():
    """``PRETRAINED_WEIGHTS``, ``fold_bn_variables`` (the JAX fold on a
    variable tree, bit for bit, bound in ``models.craft`` as JAX binds it
    and imported from there by ``detection``), ``resize_bilinear`` in
    ``models.craft``, ``map_to_rgb`` and the reference's graph builder
    names."""
    from keras_ocr_tpu.models import craft as jcraft
    from keras_ocr_tpu_torch.models import craft
    from keras_ocr_tpu_torch.models.craft import fold_bn_variables, resize_bilinear
    from keras_ocr_tpu_torch.ops import image

    assert detection.PRETRAINED_WEIGHTS.keys() == jdetection.PRETRAINED_WEIGHTS.keys()
    assert detection.fold_bn_variables is fold_bn_variables
    assert resize_bilinear is image.resize_bilinear
    assert _positional(fold_bn_variables) == _positional(jcraft.fold_bn_variables)
    tree = jax.tree.map(np.asarray, JaxDetector(weights=None, width=0.125,
                                                max_components=16).variables)
    ours = dict(_leaves(fold_bn_variables(tree)))
    ref = dict(_leaves(jax.tree.map(np.asarray, jcraft.fold_bn_variables(tree))))
    assert ours.keys() == ref.keys()
    for path, value in ref.items():
        np.testing.assert_array_equal(ours[path], value, err_msg=path)
    x = np.random.RandomState(1).rand(2, 5, 7, 3).astype(np.float32)
    np.testing.assert_array_equal(resize_bilinear(torch.from_numpy(x), 9, 4).numpy(),
                                  np.asarray(jcraft.resize_bilinear(x, 9, 4)))
    y = np.random.RandomState(0).rand(5, 7, 2).astype(np.float32)
    np.testing.assert_array_equal(detection.map_to_rgb(y), jdetection.map_to_rgb(y))
    assert (detection.make_vgg_block, detection.upconv, detection.build_vgg_backbone) == (
        craft.ConvBN, craft.UpConv, craft.VGG16BN)


def test_build_efficientnet_backbone_takes_a_dtype():
    """``(model_name, dtype)`` as JAX's; a bfloat16 backbone computes in
    bf16 from a float32 input, with float32 parameters."""
    assert _positional(detection.build_efficientnet_backbone) == _positional(
        jdetection.build_efficientnet_backbone)
    backbone = detection.build_efficientnet_backbone("efficientnetb0", torch.bfloat16).eval()
    assert {p.dtype for p in backbone.parameters()} == {torch.float32}
    with torch.no_grad():
        taps = backbone(torch.zeros(1, 3, 32, 32))
    assert len(taps) == 4 and {t.dtype for t in taps} == {torch.bfloat16}
    with pytest.raises(NotImplementedError):
        detection.build_efficientnet_backbone("efficientnetb0", torch.float16)


@pytest.mark.parametrize("name", ["warp_boxes_batch", "conv3x3_bias_act", "conv_chain"])
def test_kernel_wrappers_take_the_jax_parameters(name):
    from keras_ocr_tpu.ops import conv_pallas, warp as jwarp
    from keras_ocr_tpu_torch.ops import conv_cuda, warp

    ours = getattr(warp if name == "warp_boxes_batch" else conv_cuda, name)
    ref = getattr(jwarp if name == "warp_boxes_batch" else conv_pallas, name)
    assert _positional(ours) == _positional(ref)


def test_conv_wrappers_in_jax_order_match_the_plain_versions():
    """``conv3x3_bias_act(x, w, b, 8, False)`` is the plain layer without
    ReLU; ``out_dtype`` casts the layer's result; ``conv_chain``'s
    ``tile_h`` / ``interpret`` / ``out_dtype`` likewise, the tap too."""
    from keras_ocr_tpu_torch.ops import conv_cuda

    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(2, 10, 12, 5).astype(np.float32))
    w = torch.from_numpy(rng.randn(3, 3, 5, 6).astype(np.float32) * 0.2)
    b = torch.from_numpy(rng.randn(6).astype(np.float32))
    plain = conv_cuda.conv3x3_bias_act_plain(x, w, b, relu=False)
    assert (plain < 0).any()
    torch.testing.assert_close(conv_cuda.conv3x3_bias_act(x, w, b, 8, False), plain,
                               rtol=0, atol=0)
    out = conv_cuda.conv3x3_bias_act(x, w, b, 8, False, False, torch.bfloat16)
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out, plain.to(torch.bfloat16), rtol=0, atol=0)
    convs = [(w, b, True), (torch.from_numpy(rng.randn(1, 1, 6, 4).astype(np.float32)),
                            torch.from_numpy(rng.randn(4).astype(np.float32)), False)]
    main, tap = conv_cuda.conv_chain(x, convs, True, True, 16, False, torch.bfloat16)
    ref_main, ref_tap = conv_cuda.conv_chain_plain(x, convs, pool=True, tap_prepool=True)
    assert main.dtype == tap.dtype == torch.bfloat16
    torch.testing.assert_close(main, ref_main.to(torch.bfloat16), rtol=0, atol=0)
    torch.testing.assert_close(tap, ref_tap.to(torch.bfloat16), rtol=0, atol=0)


def test_warp_boxes_batch_ignores_word_chunk():
    from keras_ocr_tpu_torch.ops import warp

    rng = np.random.RandomState(1)
    images = torch.from_numpy(rng.rand(1, 40, 60).astype(np.float32) * 255)
    boxes = torch.tensor([[[[2, 3], [30, 4], [31, 15], [3, 14]]] * 3], dtype=torch.float32)
    whole = warp.warp_boxes_batch(images, boxes, 31, 200, 64, 512, 0)
    torch.testing.assert_close(warp.warp_boxes_batch(images, boxes, 31, 200, 64, 512, 2), whole,
                               rtol=0, atol=0)


@pytest.mark.parametrize("module, name", [
    ("data_generation", "draw_text_image"), ("data_generation", "get_image_generator"),
    ("data_generation", "get_fonts"), ("data_generation", "font_supports_alphabet"),
    ("tools", "drawBoxes"), ("tools", "drawAnnotations")])
def test_rendering_and_drawing_names_take_jax_signatures(module, name):
    """The synthetic-data and drawing functions are bound where JAX binds
    them, with JAX's parameters, defaults and order."""
    import importlib

    ours = getattr(importlib.import_module(f"keras_ocr_tpu_torch.{module}"), name)
    ref = getattr(importlib.import_module(f"keras_ocr_tpu.{module}"), name)
    theirs, mine = inspect.signature(ref).parameters, inspect.signature(ours).parameters
    assert list(mine) == list(theirs)
    assert [p.default for p in mine.values()] == [p.default for p in theirs.values()]
