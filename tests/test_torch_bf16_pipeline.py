"""The bfloat16 pipeline on the CPU: the golden artifact built with
``compute_dtype=torch.bfloat16`` in the port (standard and BN-folded) reads
the words the JAX package's bfloat16 golden pipeline reads on three of its
scenes (all twelve run on the card in ``chip_smoke.py``, which also
exports both bfloat16 graphs and serves them); both trainers step a
bfloat16 model.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keras_ocr_tpu.utils import golden as jgolden
from keras_ocr_tpu_torch import tools
from keras_ocr_tpu_torch.detection import Detector
from keras_ocr_tpu_torch.recognition import Recognizer
from keras_ocr_tpu_torch.train import DetectorTrainer, RecognizerTrainer
from keras_ocr_tpu_torch.utils import golden

torch.set_num_threads(2)

GOLDEN = os.path.join(os.path.dirname(__file__), "fixtures", "golden_offline")
with open(os.path.join(GOLDEN, "expected.json"), encoding="utf8") as _f:
    SCENES = [entry["image"] for entry in json.load(_f)["scenes"]]
CHOSEN = [SCENES[0], SCENES[1], SCENES[6]]


@pytest.fixture(scope="module")
def jax_words():
    pipeline, _ = jgolden.load_golden_pipeline(GOLDEN, jnp.bfloat16)
    return [[word for word, _ in pipeline.recognize([tools.read(os.path.join(GOLDEN, s))])[0]]
            for s in CHOSEN]


@pytest.mark.parametrize("fold_bn", [False, True], ids=["standard", "folded"])
def test_golden_bf16_reads_the_jax_words(jax_words, fold_bn):
    pipeline, meta = golden.load_golden_pipeline(GOLDEN, torch.bfloat16, device="cpu",
                                                 fold_bn=fold_bn)
    assert pipeline.detector.model.dtype == pipeline.recognizer.model.dtype == torch.bfloat16
    for scene, ref in zip(CHOSEN, jax_words):
        words = [word for word, _ in pipeline.recognize([tools.read(os.path.join(GOLDEN,
                                                                                 scene))])[0]]
        assert words == ref, scene


@pytest.mark.parametrize("trainer", ["detector", "recognizer"])
def test_trainers_step_a_bf16_model(trainer):
    """Both trainers take a bfloat16 model, through ``compile()`` too: a step
    gives a finite loss and leaves the parameters and their gradients
    float32 (parity with JAX's bf16 step: ``tests/test_torch_train_bf16.py``)."""
    if trainer == "detector":
        model = Detector(weights=None, width=0.125, compute_dtype=torch.bfloat16, device="cpu")
        build = DetectorTrainer
        rng = np.random.RandomState(0)
        batch = (rng.randn(2, 32, 32, 3).astype(np.float32),
                 rng.rand(2, 16, 16, 2).astype(np.float32))
    else:
        slim = dict(filters=(4,) * 7, rnn_units=(4, 4), stn=False, height=31, width=200,
                    color=False, dropout=0.25, rnn_steps_to_discard=2, pool_size=2)
        model = Recognizer("abc", None, slim, torch.bfloat16, device="cpu")
        build = RecognizerTrainer
        batch = ((np.random.RandomState(0).rand(2, 31, 200, 1).astype(np.float32),
                  np.array([[0, 1, -1], [2, -1, -1]]), np.full((2, 1), 48), np.array([[2], [1]])),
                 np.zeros(2))
    for make in (build, lambda m: m.compile()):
        trainer = make(model)
        assert np.isfinite(trainer.train_step(batch))
        assert model.model.dtype == torch.bfloat16
        for name, param in model.model.named_parameters():
            assert param.dtype == torch.float32, name
            assert param.grad is None or param.grad.dtype == torch.float32, name
