"""The port's pipeline on its own: its golden check on all 12 scenes,
``recognize_many`` against ``recognize``, named weights offline, the entry
points without a card, and the whole port with JAX unimportable.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from keras_ocr_tpu_torch.utils import golden

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_export import GOLDEN, READ_SCENES as SCENES, ROOT  # noqa: E402

torch.set_num_threads(2)

META_SLIM = {
    "height": 31, "width": 200, "color": False, "filters": (8, 8, 8, 8, 8, 8, 8),
    "rnn_units": (8, 8), "dropout": 0.25, "rnn_steps_to_discard": 2, "pool_size": 2,
    "stn": False,
}


@pytest.fixture(scope="module")
def pipelines():
    """The port's golden pipeline, where ``tests/test_torch_export.py``
    pairs it with JAX's."""
    return None, golden.load_golden_pipeline(GOLDEN, device="cpu")[0]


def test_port_golden_check_passes_on_all_scenes():
    result = golden.run_golden_check(GOLDEN, device="cpu")
    assert result["n_scenes"] == 12 and result["n_words"] >= 20
    assert result["fraction"] >= 0.85, result
    assert result["pass"]
    # Three scenes hold a word wider than the first warp window.
    assert result["run_stats"]["warp_escalations"] == 3


def test_recognize_many_equals_recognize(pipelines):
    _, port_pipeline = pipelines
    from keras_ocr_tpu_torch import tools

    images = [tools.read(os.path.join(GOLDEN, scene)) for scene in SCENES[:3]]
    single = [port_pipeline.recognize([image])[0] for image in images]
    for queue_depth in (1, 2):
        many = port_pipeline.recognize_many(images, batch_size=2, queue_depth=queue_depth)
        assert [[w for w, _ in r] for r in many] == [[w for w, _ in r] for r in single]
        for got, want in zip(many, single):
            for (_, box), (_, ref_box) in zip(got, want):
                np.testing.assert_allclose(box, ref_box, atol=1e-3)


def test_unported_options_raise(tmp_path, monkeypatch):
    """Named weights resolve offline or raise, as in the JAX package: with
    nothing vendored or cached and the network refused, ``Detector()`` and
    ``Recognizer()`` raise ``RuntimeError`` naming the file, and
    ``allow_random_fallback=True`` warns and keeps the random weights. A
    width other than 1.0 or a non-VGG backbone with named weights raises
    ``ValueError``; without them an EfficientNet backbone looks for its
    ImageNet file, and warns and keeps random weights where it cannot be
    had."""
    import urllib.request

    from keras_ocr_tpu_torch import Detector, Pipeline, Recognizer

    def refuse(*args, **kwargs):
        raise OSError("no network in the tests")

    monkeypatch.setattr(urllib.request, "urlopen", refuse)
    monkeypatch.setenv("KERAS_OCR_TPU_VENDORED_WEIGHTS", str(tmp_path / "vendored"))
    monkeypatch.setenv("KERAS_OCR_TPU_CACHE_DIR", str(tmp_path / "cache"))
    monkeypatch.delenv("KERAS_OCR_TPU_WEIGHTS_MIRROR", raising=False)
    with pytest.raises(ValueError):
        Detector(weights="clovaai_general", width=0.5, device="cpu")
    with pytest.raises(ValueError):
        Detector(backbone_name="efficientnetb0", device="cpu")
    with pytest.warns(UserWarning, match="ImageNet initialization for efficientnetb0"):
        efficientnet = Detector(weights=None, backbone_name="efficientnetb0", device="cpu")
    assert efficientnet.model.basenet.channels == {"s1": 96, "s2": 144, "s3": 240, "s4": 480}
    with pytest.raises(RuntimeError, match="craft_mlt_25k.h5"):
        Detector(device="cpu")
    with pytest.raises(RuntimeError, match="craft_mlt_25k.pth"):
        Detector(load_from_torch=True, device="cpu")
    with pytest.raises(RuntimeError, match="crnn_kurapan.h5"):
        Recognizer(device="cpu")
    with pytest.warns(UserWarning, match="RANDOM initialization"):
        fallback = Detector(device="cpu", allow_random_fallback=True)
    assert fallback.width == 1.0
    pipeline = Pipeline(
        detector=Detector(weights=None, width=0.25, device="cpu"),
        recognizer=Recognizer(weights=None, build_params=dict(META_SLIM), device="cpu"),
        max_size=64,
    )
    # 48 x 2 > max_size: the non-uniform path, ported now, runs.
    assert len(pipeline.recognize([np.zeros((48, 40, 3), np.uint8)])) == 1


@pytest.mark.parametrize("entry", ["Detector", "Recognizer", "Pipeline"])
def test_entry_points_need_a_card_or_an_explicit_cpu(monkeypatch, entry):
    """Without a card the entry points raise unless given device="cpu":
    nothing falls back to the CPU on its own."""
    import keras_ocr_tpu_torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        getattr(keras_ocr_tpu_torch, entry)()
    detector = keras_ocr_tpu_torch.Detector(weights=None, width=0.25, device="cpu")
    recognizer = keras_ocr_tpu_torch.Recognizer(weights=None, build_params=dict(META_SLIM),
                                                device="cpu")
    built = {
        "Detector": detector,
        "Recognizer": recognizer,
        "Pipeline": keras_ocr_tpu_torch.Pipeline(detector=detector, recognizer=recognizer),
    }[entry]
    assert built.device == torch.device("cpu")


def test_port_runs_with_jax_blocked(tmp_path):
    """The port, its pipeline, the refine pass, ``Detector.detect``,
    ``read`` of a PNG buffer and of a JPEG path, ``Pipeline.export`` and
    ``load_exported`` import and run with jax, flax and the JAX package
    unimportable (as on a machine without JAX)."""
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'flax', 'keras_ocr_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import torch\n"
        "torch.set_num_threads(2)\n"
        "import keras_ocr_tpu_torch\n"
        "from keras_ocr_tpu_torch.pipeline import Pipeline\n"
        "from keras_ocr_tpu_torch.utils import golden\n"
        "import io\n"
        "import keras_ocr_tpu_torch.ops.refine\n"
        "from keras_ocr_tpu_torch import tools\n"
        "pipeline, meta = golden.load_golden_pipeline(sys.argv[1], device='cpu')\n"
        "words = [w for w, _ in pipeline.recognize([sys.argv[1] + '/scene_00.png'])[0]]\n"
        "assert words, words\n"
        "with open(sys.argv[1] + '/scene_01.png', 'rb') as f:\n"
        "    image = tools.read(io.BytesIO(f.read()))\n"
        "boxes = pipeline.detector.detect([image])[0]\n"
        "assert boxes.shape[1:] == (4, 2) and len(boxes), boxes.shape\n"
        "photo = tools.read(sys.argv[2])\n"
        "assert photo.shape == (480, 640, 3), photo.shape\n"
        "base = sys.argv[3] + '/ocr'\n"
        "assert pipeline.export(base, height=64, width=96, refine_level=0) == base + '.pt2'\n"
        "served = keras_ocr_tpu_torch.load_exported(base)\n"
        "assert len(served.recognize([photo[:64, :96]])) == 1\n"
        "assert not any(m.startswith(('jax', 'flax', 'keras_ocr_tpu.')) "
        "for m in sys.modules if sys.modules[m] is not None)\n"
        "print('words', words)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code, GOLDEN,
         os.path.join(ROOT, "tests", "fixtures", "test_image.jpg"), str(tmp_path)],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "words" in proc.stdout

