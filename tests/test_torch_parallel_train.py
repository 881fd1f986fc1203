"""The port's trainers on a mesh against the JAX package's on its 8 fake
CPU devices, with the port's fake devices ``[torch.device("cpu")] * n``:
one ``RecognizerTrainer`` step at (8, 1), (4, 2) with
``tensor_parallel=True`` and the hybrid (2, 2, 2) against the port's
one-device step and JAX's step on the same mesh shape, and one
``DetectorTrainer`` step at (4, 1) (in float64, as
``tests/test_torch_train_detector.py`` holds CRAFT's step). Bars: the loss
within 1e-4 relative (JAX's own test's), parameters and BatchNorm running
statistics within 1e-4 * max(1, max|ref|) (PARITY.md). Every parity model
has dropout 0: ``jax.random`` and ``torch.Generator`` draw different
masks. The JAX steps are module fixtures.
"""

import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keras_ocr_tpu.detection import Detector as JaxDetector
from keras_ocr_tpu.models.craft import CRAFT as JaxCRAFT
from keras_ocr_tpu.parallel import mesh as jmesh
from keras_ocr_tpu.recognition import Recognizer as JaxRecognizer
from keras_ocr_tpu.train import DetectorTrainer as JaxDetectorTrainer
from keras_ocr_tpu.train import RecognizerTrainer as JaxRecognizerTrainer
from keras_ocr_tpu_torch import Detector, Recognizer
from keras_ocr_tpu_torch.parallel import mesh as mesh_lib
from keras_ocr_tpu_torch.train import DetectorTrainer, RecognizerTrainer

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_parallel import (ALPHABET, CPU, INDEXED, TINY_CRNN, _jax_mesh,  # noqa: E402
                                 _leaves, _port_mesh)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def jax_recognizer():
    recognizer = JaxRecognizer(ALPHABET, None, TINY_CRNN)
    return recognizer, jax.tree.map(np.asarray, recognizer.variables)


def _recognizer_batch(size=8, seed=0):
    rng = np.random.RandomState(seed)
    frames = TINY_CRNN["width"] // 4 - TINY_CRNN["rnn_steps_to_discard"]
    images = rng.rand(size, 31, 64, 1).astype(np.float32)
    label_length = rng.randint(1, 5, size=(size, 1)).astype(np.int32)
    labels = np.full((size, 8), -1, np.int32)
    for i, n in enumerate(label_length[:, 0]):
        labels[i, :n] = rng.randint(0, len(ALPHABET), size=n)
    input_length = np.full((size, 1), frames, np.int32)
    weights = (rng.rand(size) + 0.5).astype(np.float32)
    return (images, labels, input_length, label_length), np.zeros(size), weights


RECOGNIZER_MESHES = {"dp_8x1": ("create_mesh", False), "tp_4x2": ("4x2", True),
                     "hybrid_2x2x2": ("hybrid_2x2x2", False)}


def _port_step(make_trainer, model_variables, **kwargs):
    trainer = make_trainer(model_variables, **kwargs)
    loss = trainer.train_step(_recognizer_batch())
    return loss, dict(_leaves(trainer.variables))


def _assert_step_close(ours, ref, what):
    (loss, leaves), (ref_loss, ref_leaves) = ours, ref
    assert abs(loss - ref_loss) <= 1e-4 * abs(ref_loss), (what, loss, ref_loss)
    assert leaves.keys() == ref_leaves.keys()
    for path, value in ref_leaves.items():
        value = np.asarray(value)
        err = np.abs(np.asarray(leaves[path]) - value).max()
        assert err <= 1e-4 * max(1.0, np.abs(value).max()), (what, path, err)


def _port_recognizer_trainer(variables, **kwargs):
    recognizer = Recognizer(ALPHABET, None, TINY_CRNN, device="cpu").load_variables(variables)
    return RecognizerTrainer(recognizer, **kwargs)


@pytest.fixture(scope="module")
def recognizer_steps(jax_recognizer):
    """The port's one-device step, and JAX's step on each mesh."""
    recognizer, variables = jax_recognizer
    jax_steps = {}
    for case, (name, tensor_parallel) in RECOGNIZER_MESHES.items():
        recognizer.variables = jax.tree.map(jnp.asarray, variables)
        trainer = JaxRecognizerTrainer(recognizer, mesh=_jax_mesh(name),
                                       tensor_parallel=tensor_parallel)
        loss = trainer.train_step(_recognizer_batch(), jax.random.PRNGKey(0))
        jax_steps[case] = loss, dict(_leaves(jax.tree.map(np.asarray, trainer.variables)))
    return variables, _port_step(_port_recognizer_trainer, variables), jax_steps


@pytest.mark.parametrize("case", RECOGNIZER_MESHES)
def test_recognizer_step_on_a_mesh_matches(recognizer_steps, case):
    variables, one_device, jax_steps = recognizer_steps
    name, tensor_parallel = RECOGNIZER_MESHES[case]
    mesh = _port_mesh(name)
    ours = _port_step(_port_recognizer_trainer, variables, mesh=mesh,
                      tensor_parallel=tensor_parallel)
    _assert_step_close(ours, one_device, "port one-device step")
    _assert_step_close(ours, jax_steps[case], "JAX step")
    # The hybrid step is JAX's own hybrid-equals-plain case.
    _assert_step_close(jax_steps[case], one_device, "JAX step vs the port's one-device step")


def test_tensor_parallel_splits_the_kernels(jax_recognizer, monkeypatch):
    """On (4, 2) every data position's replica splits fc_9 and both LSTMs
    over its two devices (fc_12's 9 columns do not divide 2) and computes
    each block apart; the model itself stays whole."""
    from keras_ocr_tpu_torch.models import crnn

    _, variables = jax_recognizer
    trainer = _port_recognizer_trainer(variables, mesh=_port_mesh("4x2", INDEXED),
                                       tensor_parallel=True)
    for replica, row in zip(trainer.parallel.replicas, mesh_lib.data_rows(trainer.mesh)):
        assert replica.tensor_parallel == {replica.fc_9: row, replica.lstm_10: row,
                                           replica.lstm_11: row}
    assert not trainer.model.tensor_parallel
    calls = []
    for name in ("column_parallel", "bilstm_steps"):
        def counted(*args, fn=getattr(crnn, name), name=name):
            calls.append((name, len(args[-1])))
            return fn(*args)
        monkeypatch.setattr(crnn, name, counted)
    trainer.train_step(_recognizer_batch())
    assert sorted(calls) == [("bilstm_steps", 2)] * 8 + [("column_parallel", 2)] * 4


def _detector_batch():
    rng = np.random.RandomState(0)
    images = rng.randn(4, 64, 64, 3).astype(np.float32)
    targets = (rng.rand(4, 32, 32, 2) * 0.05).astype(np.float32)
    targets[0, 6:14, 4:20, 0] = rng.uniform(0.3, 1.0, (8, 16))
    targets[2, 20:28, 12:30, 1] = rng.uniform(0.3, 1.0, (8, 18))
    return images, targets, np.array([1.0, 0.5, 2.0, 1.0], np.float32)


@pytest.fixture(scope="module")
def detector_step():
    """JAX's CRAFT step on a (4, 1) mesh in float64, and its start."""
    variables = jax.tree.map(np.asarray, JaxDetector(weights=None, width=0.125).variables)
    with jax.enable_x64(True):
        wide = types.SimpleNamespace(
            model=JaxCRAFT(width=0.125, dtype=jnp.float64),
            variables=jax.tree.map(lambda leaf: jnp.asarray(leaf, jnp.float64), variables))
        trainer = JaxDetectorTrainer(wide, mesh=jmesh.create_mesh(
            shape=(4, 1), devices=jax.devices()[:4]))
        loss = trainer.train_step(_detector_batch())
        leaves = dict(_leaves(jax.tree.map(np.asarray, trainer.variables)))
    return variables, (loss, leaves)


def test_detector_step_on_a_mesh_matches(detector_step):
    variables, jax_step = detector_step

    def step(mesh=None):
        detector = Detector(weights=None, width=0.125, device="cpu").load_variables(variables)
        detector.model.double()
        trainer = DetectorTrainer(detector, mesh=mesh)
        return trainer.train_step(_detector_batch()), dict(_leaves(trainer.variables))

    ours = step(mesh_lib.create_mesh((4, 1), devices=[CPU] * 4))
    _assert_step_close(ours, step(), "port one-device step")
    _assert_step_close(ours, jax_step, "JAX step")


def test_indivisible_batch_and_foreign_mesh_raise(jax_recognizer):
    _, variables = jax_recognizer
    trainer = _port_recognizer_trainer(variables, mesh=_port_mesh("create_mesh"))
    with pytest.raises(ValueError, match="does not divide"):
        trainer.train_step(_recognizer_batch(size=4))
    with pytest.raises(TypeError, match="Mesh"):
        _port_recognizer_trainer(variables, mesh=_jax_mesh("create_mesh"))


def test_dropout_on_a_mesh_draws_per_shard_from_the_step_generator(jax_recognizer):
    """With dropout, a mesh step draws each shard's mask from its own
    generator seeded from the step's in mesh order: the same generator seed
    gives the same step, another seed another."""
    _, variables = jax_recognizer

    def loss(seed):
        recognizer = Recognizer(ALPHABET, None, dict(TINY_CRNN, dropout=0.25), device="cpu")
        trainer = RecognizerTrainer(recognizer.load_variables(variables),
                                    mesh=_port_mesh("hybrid_2_default"))
        return trainer.train_step(_recognizer_batch(), torch.Generator().manual_seed(seed))

    assert loss(3) == loss(3) != loss(4)
