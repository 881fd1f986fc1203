"""Port parity for the whole slice: the golden pipeline in both packages.

The committed golden artifact (trained slim CRAFT + CRNN) runs through the
JAX ``Pipeline`` and the port's ``Pipeline`` on the same scenes: the words
must be equal, every box matched at IoU > 0.9, and the escalation ladders
must take the same steps. The same holds for the BN-folded detector
(JAX ``fold_bn_variables``; the port folds the standard checkpoint on
load). Then the port's own ``run_golden_check`` must pass on all 12
scenes. Random weights are not used here: their heatmaps sit on threshold
knife edges.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from keras_ocr_tpu import evaluation
from keras_ocr_tpu.utils import golden as jgolden
from keras_ocr_tpu_torch.utils import golden

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "fixtures", "golden_offline")
SCENES = ["scene_00.png", "scene_01.png", "scene_02.png", "scene_03.png"]
META_SLIM = {
    "height": 31, "width": 200, "color": False, "filters": (8, 8, 8, 8, 8, 8, 8),
    "rnn_units": (8, 8), "dropout": 0.25, "rnn_steps_to_discard": 2, "pool_size": 2,
    "stn": False,
}


@pytest.fixture(scope="module")
def pipelines():
    jax_pipeline, _ = jgolden.load_golden_pipeline(GOLDEN)
    port_pipeline, _ = golden.load_golden_pipeline(GOLDEN, device="cpu")
    return jax_pipeline, port_pipeline


@pytest.fixture(scope="module")
def folded_pipelines(pipelines):
    """The JAX pipeline with ``Detector(fold_bn=True)`` on the folded
    checkpoint, and the port's folded golden pipeline."""
    from keras_ocr_tpu.detection import Detector as JaxDetector
    from keras_ocr_tpu.models.craft import fold_bn_variables
    from keras_ocr_tpu.pipeline import Pipeline as JaxPipeline
    from keras_ocr_tpu.train.checkpoint import restore_npz

    jax_pipeline, _ = pipelines
    meta = golden._read_json(GOLDEN, golden.META_NAME)
    detector = JaxDetector(
        weights=None, width=meta["detector_width"], max_components=meta["max_components"],
        fold_bn=True,
    )
    detector.variables = fold_bn_variables(restore_npz(os.path.join(GOLDEN, golden.DETECTOR_NAME)))
    jax_folded = JaxPipeline(
        detector=detector, recognizer=jax_pipeline.recognizer, scale=meta["scale"],
        pad_to=tuple(meta["pad_to"]), max_words=meta["max_words"],
    )
    port_folded, _ = golden.load_golden_pipeline(GOLDEN, device="cpu", fold_bn=True)
    return jax_folded, port_folded


def _assert_same_reading(jax_pipeline, port_pipeline, scene):
    from keras_ocr_tpu import tools as jtools

    image = jtools.read(os.path.join(GOLDEN, scene))
    ref = jax_pipeline.recognize([image])[0]
    out = port_pipeline.recognize([image])[0]
    assert [word for word, _ in out] == [word for word, _ in ref]
    for (_, box), (_, ref_box) in zip(out, ref):
        assert box.shape == (4, 2) and box.dtype == np.float32
        assert evaluation.iou_score(box, ref_box) > 0.9
    common = set(jax_pipeline.last_run_stats) & set(port_pipeline.last_run_stats)
    assert {k: port_pipeline.last_run_stats[k] for k in common} == {
        k: jax_pipeline.last_run_stats[k] for k in common
    }


@pytest.mark.parametrize("scene", SCENES)
def test_golden_scene_matches_jax_pipeline(pipelines, scene):
    _assert_same_reading(*pipelines, scene)


@pytest.mark.parametrize("scene", SCENES[:2])
def test_folded_golden_scene_matches_jax_pipeline(folded_pipelines, scene):
    _assert_same_reading(*folded_pipelines, scene)


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


def test_unported_options_raise():
    from keras_ocr_tpu_torch import Detector, Pipeline, Recognizer

    with pytest.raises(ValueError):
        Detector(weights="clovaai_general", width=0.5, device="cpu")
    with pytest.raises(NotImplementedError):
        Detector(weights="clovaai_general", device="cpu")
    with pytest.raises(NotImplementedError):
        Recognizer(weights="kurapan", device="cpu")
    pipeline = Pipeline(
        detector=Detector(width=0.25, device="cpu"),
        recognizer=Recognizer(build_params=dict(META_SLIM), device="cpu"),
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
    detector = keras_ocr_tpu_torch.Detector(width=0.25, device="cpu")
    recognizer = keras_ocr_tpu_torch.Recognizer(build_params=dict(META_SLIM), device="cpu")
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

