"""Port parity of detector training: CRAFT in training mode, the MSE and
OHEM losses, Adam and ``DetectorTrainer``, against the JAX package on the
CPU.

CRAFT at width 0.125, 64x64 inputs, batch 2. Bars: one step's heatmaps
within 1e-4, the loss within 1e-5 relative, each gradient leaf within 1e-4
of its largest magnitude, the running statistics after the step within
1e-5 of theirs (under both losses); three trainer steps within 1e-4 of the
JAX trainer's losses (one-device mesh); ``ohem_mse_loss`` within 1e-5 of
the numpy oracle of ``tests/test_train.py``.

The single step is held against the JAX module run in float64
(``jax.enable_x64``): Flax's training-mode BatchNorm differentiates its
fast variance, E[x^2] - E[x]^2, and its float32 gradients sit up to 2.1e-4
(of a leaf's largest) from the float64 ones, where the port's float32
gradients sit within 1.3e-5 (``scripts/train_parity_cpu.py``). Leaves whose gradient is zero in exact
arithmetic (a conv bias that a BatchNorm follows; at 64x64 also
``slice4_37``'s BatchNorm shift, which every path hands to a BatchNorm as a
per-channel constant) are held to rounding noise instead: below 1e-5 of
the model's largest gradient.

Also the bfloat16 CRAFT step (VGG at width 0.25 on a (2, 64, 96) batch)
against the JAX trainer's step op by op and, on two CPU devices, against
the one-device step, with the bars and helpers of
``tests/test_torch_train_bf16.py`` (in ``tests/test_torch_train_bf16_craft.py``
before: a file of two tests, which ``pytest-xdist``'s ``--dist loadfile``
queued last, as it queues files by their number of tests, so that its
op-by-op JAX step ended the run).
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
from keras_ocr_tpu.parallel import mesh as mesh_lib
from keras_ocr_tpu.train import DetectorTrainer as JaxDetectorTrainer
from keras_ocr_tpu.train.detector import ohem_mse_loss as jax_ohem_mse_loss
from keras_ocr_tpu_torch import Detector, weights
from keras_ocr_tpu_torch.models import CRAFT
from keras_ocr_tpu_torch.parallel import mesh as port_mesh
from keras_ocr_tpu_torch.train import DetectorTrainer
from keras_ocr_tpu_torch.train.callbacks import CSVLogger
from keras_ocr_tpu_torch.train.detector import ohem_mse_loss

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_train_bf16 import (CPU, assert_float32_state, assert_step_close,  # noqa: E402
                                   check_against_jax, craft_variables, jax_craft_step,
                                   port_craft_step, zero_leaves)

torch.set_num_threads(2)

WIDTH = 0.125
_JAX = {}


def _jax_detector():
    """The JAX detector (built once) and a fresh numpy copy of its initial
    variables."""
    if not _JAX:
        detector = JaxDetector(weights=None, width=WIDTH, max_components=16)
        _JAX["detector"] = detector
        _JAX["variables"] = jax.tree.map(np.asarray, detector.variables)
    return _JAX["detector"], jax.tree.map(np.copy, _JAX["variables"])


def _port_detector(variables, **kwargs):
    return Detector(weights=None, width=WIDTH, device="cpu", **kwargs).load_variables(variables)


def _batch(seed=0):
    """Normalised images and targets with text and link blobs."""
    rng = np.random.RandomState(seed)
    images = rng.randn(2, 64, 64, 3).astype(np.float32)
    targets = (rng.rand(2, 32, 32, 2) * 0.05).astype(np.float32)
    targets[0, 6:14, 4:20, 0] = rng.uniform(0.3, 1.0, (8, 16))
    targets[0, 8:12, 10:26, 1] = rng.uniform(0.3, 1.0, (4, 16))
    targets[1, 20:28, 12:30, 0] = rng.uniform(0.3, 1.0, (8, 18))
    weights_ = np.array([1.0, 0.5], np.float32)
    return images, targets, weights_


JAX_LOSSES = {
    "mse": lambda p, t, w: jnp.mean(jnp.mean((p - t) ** 2, axis=(1, 2, 3)) * w),
    "ohem": jax_ohem_mse_loss,
}


@pytest.fixture(scope="module", params=["mse", "ohem"])
def craft_step(request):
    """One JAX training step in float64: heatmaps, loss, gradients and
    running statistics."""
    _, variables = _jax_detector()
    images, targets, sample_weights = _batch()
    loss_of = JAX_LOSSES[request.param]
    with jax.enable_x64(True):
        model = JaxCRAFT(width=WIDTH, dtype=jnp.float64)
        wide = jax.tree.map(lambda leaf: np.asarray(leaf, np.float64), variables)

        def loss_fn(params):
            preds, updates = model.apply(
                {"params": params, "batch_stats": wide["batch_stats"]},
                images.astype(np.float64), train=True, mutable=["batch_stats"])
            return loss_of(preds, targets.astype(np.float64), sample_weights.astype(np.float64)), (
                preds, updates["batch_stats"])

        (loss, (preds, stats)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            wide["params"])
        step = {"loss": float(loss), "preds": np.asarray(preds),
                "grads": jax.tree.map(np.asarray, grads), "stats": jax.tree.map(np.asarray, stats)}
    return dict(step, loss_name=request.param, variables=variables)


def _leaves(tree, prefix=""):
    for key, value in sorted(tree.items()):
        if isinstance(value, dict):
            yield from _leaves(value, f"{prefix}{key}/")
        else:
            yield f"{prefix}{key}", np.asarray(value)


def _assert_leaves_close(ours, ref, bar, what):
    ours, ref = dict(_leaves(ours)), dict(_leaves(ref))
    assert ours.keys() == ref.keys()
    largest = max(np.abs(value).max() for value in ref.values())
    for path, value in ref.items():
        scale = np.abs(value).max()
        if scale <= 1e-9 * largest:  # zero in exact arithmetic: rounding noise only
            assert np.abs(ours[path]).max() <= 1e-5 * largest, (what, path)
            continue
        err = np.abs(ours[path] - value).max()
        assert err <= bar * scale, (what, path, err / scale)


def test_craft_train_step_matches_jax(craft_step):
    detector = _port_detector(craft_step["variables"])
    images, targets, sample_weights = _batch()
    detector.model.train()
    with torch.no_grad():
        preds = detector.model(torch.from_numpy(images)).numpy()
    np.testing.assert_allclose(preds, craft_step["preds"], rtol=0, atol=1e-4)
    detector.load_variables(craft_step["variables"])  # undo the statistics update

    trainer = DetectorTrainer(detector, loss=craft_step["loss_name"])
    loss = trainer.train_step((images, targets, sample_weights))
    assert abs(loss - craft_step["loss"]) <= 1e-5 * abs(craft_step["loss"])
    state = dict(detector.model.state_dict())
    state.update({name: param.grad for name, param in detector.model.named_parameters()})
    _assert_leaves_close(weights.craft_variables(state)["params"], craft_step["grads"], 1e-4,
                         "grad")
    _assert_leaves_close(trainer.variables["batch_stats"], craft_step["stats"], 1e-5, "stats")
    assert not detector.model.training


def _ohem_oracle(preds, targets, weights_, pos_threshold=0.1, neg_ratio=3, min_negatives=512):
    """The numpy statement of OHEM of ``tests/test_train.py``."""
    batch, _, _, channels = preds.shape
    per_sample = np.zeros(batch)
    for b in range(batch):
        channel_losses = []
        for c in range(channels):
            err = (preds[b, ..., c] - targets[b, ..., c]).ravel() ** 2
            pos = targets[b, ..., c].ravel() > pos_threshold
            n_pos = int(pos.sum())
            neg_err = np.sort(err[~pos])[::-1]
            k = (min(neg_ratio * n_pos, neg_err.size) if n_pos
                 else min(min_negatives, neg_err.size))
            total = err[pos].sum() + neg_err[:k].sum()
            channel_losses.append(total / max(n_pos + k, 1))
        per_sample[b] = np.mean(channel_losses)
    return float(np.mean(per_sample * weights_))


@pytest.mark.parametrize("min_negatives", [50, 512])
def test_ohem_loss_matches_numpy_oracle(min_negatives):
    """Sample 0 has positives in both channels, sample 1 in channel 0
    only, sample 2 none (the ``min_negatives`` path)."""
    rng = np.random.RandomState(3)
    preds = rng.rand(3, 16, 24, 2).astype("float32")
    targets = np.zeros_like(preds)
    targets[0, 2:6, 3:9, :] = rng.uniform(0.3, 1.0, (4, 6, 2))
    targets[1, 8:12, 1:5, 0] = rng.uniform(0.3, 1.0, (4, 4))
    weights_ = np.array([1.0, 0.5, 2.0], dtype="float32")
    ours = float(ohem_mse_loss(torch.from_numpy(preds), torch.from_numpy(targets),
                               torch.from_numpy(weights_), min_negatives=min_negatives))
    oracle = _ohem_oracle(preds, targets, weights_, min_negatives=min_negatives)
    np.testing.assert_allclose(ours, oracle, rtol=1e-5)


def test_trainer_loss_trajectory_matches_jax():
    """Three steps of both trainers (default loss and Adam) on one batch,
    both models in float64. In float32 the trajectory is not reproducible
    at 1e-4 by either package: Adam's first steps move each weight by
    about the learning rate times the sign of its gradient, so rounding
    alone moves the third loss by 1.2e-3 (port) and 1.1e-3 (JAX) from the
    float64 one, 2.4e-3 apart (``scripts/train_parity_cpu.py``). The
    float32 step itself is held above."""
    _, variables = _jax_detector()
    batch = _batch(seed=1)
    with jax.enable_x64(True):
        wide = types.SimpleNamespace(
            model=JaxCRAFT(width=WIDTH, dtype=jnp.float64),
            variables=jax.tree.map(lambda leaf: jnp.asarray(leaf, jnp.float64), variables))
        reference = JaxDetectorTrainer(wide, mesh=mesh_lib.create_mesh(devices=jax.devices()[:1]))
        expected = [reference.train_step(batch) for _ in range(3)]
    detector = _port_detector(variables)
    detector.model.double()
    trainer = DetectorTrainer(detector)
    losses = [trainer.train_step(batch) for _ in range(3)]
    np.testing.assert_allclose(losses, expected, rtol=1e-4)
    assert losses[-1] < losses[0]


def test_bridge_round_trip_is_the_identity():
    _, variables = _jax_detector()
    tree = weights.craft_variables(_port_detector(variables).model)
    ours, ref = dict(_leaves(tree)), dict(_leaves(variables))
    assert ours.keys() == ref.keys()
    for path, value in ref.items():
        assert ours[path].dtype == value.dtype and np.array_equal(ours[path], value), path
    folded = weights.craft_variables(_port_detector(variables, fold_bn=True).model)
    assert set(folded) == {"params"}
    assert "bn" not in folded["params"]["basenet"]["slice1_0"]


def test_folded_graph_and_multi_device_arguments_raise():
    _, variables = _jax_detector()
    with pytest.raises(ValueError, match="inference-only"):
        DetectorTrainer(_port_detector(variables, fold_bn=True))
    model = CRAFT(width=WIDTH, fold_bn=True).train()
    with pytest.raises(ValueError, match="inference-only"):
        model(torch.zeros(1, 32, 32, 3))
    detector = _port_detector(variables)
    with pytest.raises(TypeError, match="Mesh"):
        DetectorTrainer(detector, mesh=object())
    with pytest.raises(TypeError, match="Mesh"):
        DetectorTrainer(detector, mesh=mesh_lib.create_mesh(devices=jax.devices()[:1]))
    with pytest.raises(ValueError, match="unknown loss"):
        DetectorTrainer(detector, loss="dice")


def test_fit_on_the_batch_generator(tmp_path):
    """``compile`` then ``fit`` on ``get_batch_generator`` batches of
    character lines; the model ends in eval mode and the CSV log has a row
    per epoch."""
    _, variables = _jax_detector()
    detector = _port_detector(variables)
    trainer = detector.compile(learning_rate=1e-3)
    assert detector.trainer is trainer and isinstance(trainer.optimizer, torch.optim.Adam)
    rng = np.random.RandomState(4)

    def samples():
        while True:
            image = rng.randint(0, 256, (64, 64, 3)).astype(np.uint8)
            x0, y0 = rng.randint(2, 20, size=2)
            line = [(np.array([[x0 + 9 * i, y0], [x0 + 9 * i + 8, y0], [x0 + 9 * i + 8, y0 + 12],
                               [x0 + 9 * i, y0 + 12]], np.float32), "abcd"[i]) for i in range(4)]
            yield image, [line], 1.0

    log = os.path.join(tmp_path, "log.csv")
    history = trainer.fit(detector.get_batch_generator(samples(), batch_size=2),
                          steps_per_epoch=1, epochs=2, callbacks=[CSVLogger(log)])
    assert len(history) == 2 and np.isfinite(history).all()
    assert not detector.model.training
    with open(log) as f:
        assert len(f.read().strip().splitlines()) == 3


@pytest.fixture(scope="module")
def craft_case():
    variables = craft_variables()
    return {"variables": variables, "jax": jax_craft_step(variables),
            "float32": port_craft_step(variables, torch.float32)}


def test_craft_bf16_step_matches_jax(craft_case):
    step = port_craft_step(craft_case["variables"])
    assert step["trainer"].detector.model.dtype == torch.bfloat16
    check_against_jax(craft_case, step)


def test_craft_bf16_step_on_a_mesh_matches_one_device(craft_case):
    one = port_craft_step(craft_case["variables"])
    step = port_craft_step(craft_case["variables"],
                           mesh=port_mesh.create_mesh(devices=[CPU] * 2))
    assert_float32_state(step)
    assert_step_close(step, one, zero_leaves(craft_case["float32"]["grads"]), "data_parallel")
