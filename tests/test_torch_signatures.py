"""The facades' positional order against the JAX package's: ``Detector``
takes ``compute_dtype`` fifth, ``Recognizer`` fourth and
``detection.build_model`` third, with ``device`` and ``seed`` keyword-only
in the port; the golden utility's ``load_golden_pipeline`` and
``run_golden_check`` take ``compute_dtype`` second and ``pipeline`` third,
as JAX's do. A call in JAX's positional order builds the same
configuration in both packages, in float32 and in bfloat16 (float32
parameters either way); another dtype raises ``NotImplementedError`` and a
value that is not a dtype ``TypeError``.
"""

import inspect
import os

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

    def positional(fn):
        return [p.name for p in inspect.signature(fn).parameters.values()
                if p.kind is inspect.Parameter.POSITIONAL_OR_KEYWORD]

    assert positional(Pipeline.__init__) == positional(JaxPipeline.__init__)
    assert positional(Pipeline.__init__).index("mesh") == 8  # after self
    detector = Detector(None, width=0.125, max_components=16, device="cpu")
    recognizer = Recognizer("abc", None, SLIM_CRNN, device="cpu")
    ours = Pipeline(detector, recognizer, 2, 2048, 64, 32, None, None, (16, 64))
    assert ours.word_buckets == (16, 64) and ours.mesh is None
    mesh = parallel.create_mesh(devices=[torch.device("cpu")] * 2)
    ours = Pipeline(detector, recognizer, 2, 2048, 64, 32, None, mesh, (8, 64))
    assert ours.mesh is mesh and ours.word_buckets == (8, 64)
