"""The facades of both packages on the same registry-resolved files.

Seeded full-width CRAFT and CRNN trees are written by the port's writers
into a temporary vendored directory, and ``DETECTOR_PRETRAINED`` /
``RECOGNIZER_PRETRAINED`` of both packages are patched to carry those
files' sha256, with ``urlopen`` refused. Then ``keras_ocr_tpu.Detector()``
and ``keras_ocr_tpu_torch.Detector(device="cpu")`` must give heatmaps
within 1e-4 of each other at 64x64 (``.h5`` and ``.pth``, standard and
BN-folded), the torch twin must agree with both, the recognizers' softmax
must agree within 1e-4 with equal decoded strings (the default alphabet's
top file, and another alphabet's notop file with its own ``fc_12``), and
``Pipeline()`` must build from the files and raise offline without them.
"""

import hashlib
import urllib.request

import numpy as np
import pytest
import torch

import keras_ocr_tpu
import keras_ocr_tpu_torch
from keras_ocr_tpu import weights as jweights
from keras_ocr_tpu_torch import detection, recognition, weights
from keras_ocr_tpu_torch.models import CRAFT, CRNN, init_parameters
from keras_ocr_tpu_torch.models.crnn import DEFAULT_BUILD_PARAMS

torch.set_num_threads(2)

BAR = 1e-4
OTHER_ALPHABET = "abcdefghij"


def _seed_statistics(tree, seed):
    """BatchNorm scale 0.5-1.5, shift and mean +-0.1, variance 0.5-2, so
    that loading and folding have something to carry."""
    rng = np.random.RandomState(seed)

    def walk(params, stats):
        for key in sorted(stats):
            if "mean" in stats[key]:
                n = stats[key]["mean"].shape
                params[key]["scale"] = rng.uniform(0.5, 1.5, n).astype(np.float32)
                params[key]["bias"] = rng.uniform(-0.1, 0.1, n).astype(np.float32)
                stats[key]["mean"] = rng.uniform(-0.1, 0.1, n).astype(np.float32)
                stats[key]["var"] = rng.uniform(0.5, 2.0, n).astype(np.float32)
            else:
                walk(params[key], stats[key])

    walk(tree["params"], tree["batch_stats"])
    return tree


def _entry(path):
    with open(path, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    name = path.rsplit("/", 1)[-1]
    return {"url": f"https://unreachable.invalid/{name}", "filename": name, "sha256": digest}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The trees and their registry entries (files in a vendored dir)."""
    directory = tmp_path_factory.mktemp("vendored")
    craft = _seed_statistics(weights.craft_variables(init_parameters(CRAFT(), seed=0)), 1)
    crnn = weights.crnn_variables(init_parameters(
        CRNN(alphabet_size=36, **{k: v for k, v in DEFAULT_BUILD_PARAMS.items()}), seed=2))
    crnn = _seed_statistics(crnn, 3)
    stn = crnn["params"]["stn"]["dense2"]  # off the identity, so the sampler moves
    stn["kernel"] = (np.random.RandomState(4).randn(*stn["kernel"].shape) * 0.02).astype(
        np.float32)
    stn["bias"] = np.array([0.9, 0.08, 0.05, -0.06, 1.1, 0.03], np.float32)
    detector = {
        ("clovaai_general", False): _entry(
            weights.craft_variables_to_h5(craft, str(directory / "craft_test.h5"))),
        ("clovaai_general", True): _entry(
            weights.save_craft_torch_checkpoint(craft, str(directory / "craft_test.pth"))),
    }
    recognizer = {"kurapan": {"weights": {
        "top": _entry(weights.crnn_variables_to_h5(crnn, str(directory / "crnn_test.h5"))),
        "notop": _entry(weights.crnn_variables_to_h5(
            crnn, str(directory / "crnn_test_notop.h5"), include_top=False)),
    }}}
    return {"dir": directory, "craft": craft, "crnn": crnn, "detector": detector,
            "recognizer": recognizer}


def _patch_registries(mp, files, vendored_dir):
    def refuse(*args, **kwargs):
        raise OSError("no network in the tests")

    mp.setattr(urllib.request, "urlopen", refuse)
    mp.setenv("KERAS_OCR_TPU_VENDORED_WEIGHTS", str(vendored_dir))
    mp.setenv("KERAS_OCR_TPU_CACHE_DIR", str(files["dir"] / "cache"))
    mp.delenv("KERAS_OCR_TPU_WEIGHTS_MIRROR", raising=False)
    for package in (jweights, weights):
        for key, entry in files["detector"].items():
            mp.setitem(package.DETECTOR_PRETRAINED, key, entry)
        mp.setitem(package.RECOGNIZER_PRETRAINED, "kurapan", files["recognizer"]["kurapan"])


@pytest.fixture()
def registry(files, monkeypatch):
    _patch_registries(monkeypatch, files, files["dir"])
    return files


@pytest.fixture(scope="module")
def jax_heatmaps(files):
    """The JAX detectors' heatmaps of one seeded 64x64 input, by
    (load_from_torch, fold_bn)."""
    x = np.random.RandomState(5).randn(1, 64, 64, 3).astype(np.float32)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        _patch_registries(mp, files, files["dir"])
        for key in ((False, False), (True, True)):
            detector = keras_ocr_tpu.Detector(load_from_torch=key[0], fold_bn=key[1])
            out[key] = np.asarray(detector.heatmaps(x))
    return x, out


def _leaves(tree, prefix=""):
    out = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}"
        out.update(_leaves(value, path) if isinstance(value, dict) else {path: value})
    return out


def assert_identical(got, want):
    got, want = _leaves(got), _leaves(want)
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        assert np.asarray(got[key]).tobytes() == np.asarray(value).tobytes(), key


def _close(got, ref, what):
    err = float(np.abs(np.asarray(got) - np.asarray(ref)).max())
    assert err <= BAR * max(1.0, float(np.abs(ref).max())), (what, err, float(np.abs(ref).max()))


@pytest.mark.parametrize("load_from_torch", [False, True], ids=["h5", "pth"])
@pytest.mark.parametrize("fold_bn", [False, True], ids=["standard", "folded"])
def test_detector_facades_agree(registry, jax_heatmaps, load_from_torch, fold_bn):
    x, jax_out = jax_heatmaps
    ours = keras_ocr_tpu_torch.Detector(load_from_torch=load_from_torch, fold_bn=fold_bn,
                                        device="cpu")
    if not fold_bn:
        assert_identical(weights.craft_variables(ours.model), registry["craft"])
    heatmaps = ours.heatmaps(x)
    assert heatmaps.shape == (1, 32, 32, 2)
    # Both JAX graphs agree with each other to far inside the bar, so each
    # port graph is held to the JAX run of the same file format.
    _close(heatmaps, jax_out[(True, True)] if load_from_torch else jax_out[(False, False)],
           (load_from_torch, fold_bn))


def test_twin_agrees_with_port_and_jax(registry, jax_heatmaps):
    x, jax_out = jax_heatmaps
    pth = str(registry["dir"] / registry["detector"][("clovaai_general", True)]["filename"])
    twin = detection.build_torch_model(pth)
    model, variables = detection.build_model(weights_path=pth)
    with torch.no_grad():
        theirs = twin(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
        ours = model(torch.from_numpy(x)).numpy()
    _close(theirs, ours, "twin vs port")
    _close(theirs, jax_out[(False, False)], "twin vs JAX")
    assert detection.build_keras_model is detection.build_model
    assert_identical(variables, jweights.load_torch_checkpoint(pth))
    assert_identical(detection.load_torch_weights(pth), registry["craft"])


@pytest.mark.parametrize("alphabet", [None, OTHER_ALPHABET], ids=["top", "notop"])
def test_recognizer_facades_agree(registry, alphabet, capsys):
    theirs = keras_ocr_tpu.Recognizer(alphabet=alphabet)
    ours = keras_ocr_tpu_torch.Recognizer(alphabet=alphabet, device="cpu")
    loaded = weights.crnn_variables(ours.model)
    if alphabet is None:
        assert ours.alphabet == recognition.DEFAULT_ALPHABET
        assert_identical(loaded, registry["crnn"])
    else:
        assert "backbone weights only" in capsys.readouterr().out
        # The notop file leaves fc_12 to each model's own random init: the
        # port's is its seeded one; give JAX the same to compare the rest.
        own = weights.crnn_variables(keras_ocr_tpu_torch.Recognizer(
            alphabet, None, device="cpu").model)["params"]["fc_12"]
        assert loaded["params"]["fc_12"]["kernel"].shape == (256, len(alphabet) + 1)
        assert np.asarray(theirs.variables["params"]["fc_12"]["kernel"]).shape == (256, 11)
        for key in ("kernel", "bias"):
            assert loaded["params"]["fc_12"][key].tobytes() == own[key].tobytes()
        theirs.variables["params"]["fc_12"] = dict(loaded["params"]["fc_12"])
    crops = np.random.RandomState(6).rand(4, 31, 200, 1).astype(np.float32)
    ref = np.asarray(theirs._forward(theirs.variables, crops))
    with torch.no_grad():
        softmax = ours.model(torch.from_numpy(crops)).numpy()
    _close(softmax, ref, "softmax")
    assert ours._predict_strings(crops) == theirs._predict_strings(crops)


def test_pipeline_builds_from_vendored_files_and_raises_without(registry, monkeypatch,
                                                                tmp_path):
    """``Pipeline()`` takes both default weights (here with the CPU as the
    default device); with nothing vendored or cached it raises
    ``RuntimeError`` where ``keras_ocr_tpu.Pipeline()`` does."""
    cpu = lambda: torch.device("cpu")  # noqa: E731
    monkeypatch.setattr(detection, "default_device", cpu)
    monkeypatch.setattr(recognition, "default_device", cpu)
    pipeline = keras_ocr_tpu_torch.Pipeline()
    assert_identical(weights.craft_variables(pipeline.detector.model), registry["craft"])
    assert_identical(weights.crnn_variables(pipeline.recognizer.model), registry["crnn"])
    monkeypatch.setenv("KERAS_OCR_TPU_VENDORED_WEIGHTS", str(tmp_path / "empty"))
    monkeypatch.setenv("KERAS_OCR_TPU_CACHE_DIR", str(tmp_path / "cache"))
    for package in (keras_ocr_tpu, keras_ocr_tpu_torch):
        with pytest.raises(RuntimeError, match="craft_test.h5"):
            package.Pipeline()
    with pytest.warns(UserWarning, match="RANDOM initialization"):
        keras_ocr_tpu_torch.Detector(allow_random_fallback=True)
