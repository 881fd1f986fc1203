"""Port parity of recognizer training: the CTC loss, the CRNN in training
mode, the optimisers, ``RecognizerTrainer``, callbacks and checkpoints,
against the JAX package on the CPU.

Bars: the CTC loss and its logit gradients within 1e-5 of JAX (relative to
the loss, and to the largest gradient of the sample), and within 1e-4 of
``F.ctc_loss`` on feasible labels; one train step of the tiny CRNN of
``tests/test_train.py``: logits within 1e-4, the loss within 1e-5
relative, each gradient leaf within 1e-4 of its largest magnitude, the
running statistics after the step within 1e-5 of theirs; optimiser updates
within 1e-6 of optax's; three trainer steps within 1e-4 of the JAX
trainer's losses. ``jax.random`` and ``torch.Generator`` draw different
dropout masks by design, so every parity model is built with dropout 0;
the port's dropout is tested on its own. The JAX trainer runs on a
one-device mesh; the JAX computations are shared by module fixtures.
"""

import csv
import os
import string

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.nn import functional as F

from keras_ocr_tpu.ops import ctc as jctc
from keras_ocr_tpu.parallel import mesh as mesh_lib
from keras_ocr_tpu.recognition import Recognizer as JaxRecognizer
from keras_ocr_tpu.train import RecognizerTrainer as JaxRecognizerTrainer
from keras_ocr_tpu.train import checkpoint as jcheckpoint
from keras_ocr_tpu_torch import Recognizer, weights
from keras_ocr_tpu_torch.ops import ctc
from keras_ocr_tpu_torch.train import RecognizerTrainer, checkpoint
from keras_ocr_tpu_torch.train.callbacks import CSVLogger, EarlyStopping, ModelCheckpoint
from keras_ocr_tpu_torch.train.optim import RMSprop, adam
from keras_ocr_tpu_torch.utils import golden

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "fixtures", "golden_offline")
TINY_CRNN = {
    "height": 31,
    "width": 64,
    "color": False,
    "filters": (8, 8, 8, 8, 16, 16, 16),
    "rnn_units": (16, 16),
    "dropout": 0.0,  # dropout masks cannot match across the two RNGs
    "rnn_steps_to_discard": 2,
    "pool_size": 2,
    "stn": False,
}
ALPHABET = string.ascii_lowercase[:8]
FRAMES = 64 // 4 - 2

# One CTC batch holding every edge case, a row each:
# (name, labels, label length, input length).
CTC_CASES = (
    ("plain", [0, 1, 2], 3, 12),
    ("empty_label", [], 0, 12),
    ("repeats", [1, 1, 1, 2], 4, 12),
    ("repeats_filling_frames", [2, 2, 2, 2, 2], 5, 9),
    ("short_input", [3, 4], 2, 5),
    ("infeasible", [1, 1, 1], 3, 4),
    ("padding_past_length", [0, 4, 3], 2, 12),
)
CTC_BAR = 1e-5


def _ctc_inputs():
    rng = np.random.RandomState(0)
    logits = (rng.randn(len(CTC_CASES), 12, 6) * 2).astype(np.float32)
    labels = np.full((len(CTC_CASES), 5), -1, np.int32)
    for row, (_, label, _, _) in enumerate(CTC_CASES):
        labels[row, : len(label)] = label
    label_length = np.array([case[2] for case in CTC_CASES], np.int32)
    input_length = np.array([case[3] for case in CTC_CASES], np.int32)
    return logits, labels, input_length, label_length


@pytest.fixture(scope="module")
def ctc_reference():
    """JAX losses and the gradient of sum(loss * (row + 1)): each row's
    gradient is its own loss's, scaled."""
    logits, labels, input_length, label_length = _ctc_inputs()
    scale = np.arange(1, len(CTC_CASES) + 1, dtype=np.float32)

    def total(x):
        losses = jctc.ctc_loss(x, labels, input_length, label_length)
        return jnp.sum(losses * scale), losses

    (_, losses), grads = jax.jit(jax.value_and_grad(total, has_aux=True))(logits)
    x = torch.from_numpy(logits).requires_grad_()
    ours = ctc.ctc_loss(x, torch.from_numpy(labels), torch.from_numpy(input_length),
                        torch.from_numpy(label_length))
    (ours * torch.from_numpy(scale)).sum().backward()
    return {"jax": (np.asarray(losses), np.asarray(grads)),
            "port": (ours.detach().numpy(), x.grad.numpy()),
            "inputs": (logits, labels, input_length, label_length)}


@pytest.mark.parametrize("row", range(len(CTC_CASES)), ids=[c[0] for c in CTC_CASES])
def test_ctc_loss_matches_jax(ctc_reference, row):
    (ref_loss, ref_grad), (loss, grad) = ctc_reference["jax"], ctc_reference["port"]
    assert abs(loss[row] - ref_loss[row]) <= CTC_BAR * abs(ref_loss[row])
    bar = CTC_BAR * max(np.abs(ref_grad[row]).max(), 1e-30)
    assert np.abs(grad[row] - ref_grad[row]).max() <= bar
    if CTC_CASES[row][0] == "infeasible":
        assert loss[row] > 1e29  # the -1e30 floor, as in JAX, not inf
    assert np.isfinite(grad[row]).all()


def test_ctc_loss_matches_torch_library(ctc_reference):
    """``F.ctc_loss`` (blank last) on the feasible rows, and log-probability
    input."""
    logits, labels, input_length, label_length = ctc_reference["inputs"]
    feasible = [i for i, case in enumerate(CTC_CASES) if case[0] != "infeasible"]
    log_probs = torch.log_softmax(torch.from_numpy(logits), -1)[feasible]
    library = F.ctc_loss(
        log_probs.transpose(0, 1), torch.from_numpy(labels[feasible]).clamp(min=0),
        torch.from_numpy(input_length[feasible]), torch.from_numpy(label_length[feasible]),
        blank=logits.shape[-1] - 1, reduction="none",
    ).numpy()
    ours = ctc.ctc_loss(log_probs, torch.from_numpy(labels[feasible]),
                        torch.from_numpy(input_length[feasible]),
                        torch.from_numpy(label_length[feasible]),
                        logits_are_log_probs=True).numpy()
    np.testing.assert_allclose(ours, library, rtol=1e-4)
    np.testing.assert_allclose(ours, ctc_reference["port"][0][feasible], rtol=1e-6)


@pytest.mark.parametrize("pad_value", [-1, -7])
@pytest.mark.parametrize("masked", [False, True])
def test_ctc_greedy_decode_matches_jax(pad_value, masked):
    rng = np.random.RandomState(1)
    probs = rng.rand(5, 14, 9).astype(np.float32)
    probs[:, ::3, -1] = 2.0  # blanks between runs
    probs[1, 4:8] = probs[1, 4]  # a repeated run
    mask = rng.rand(5, 14) > 0.3 if masked else None
    ref = np.asarray(jctc.ctc_greedy_decode(jnp.asarray(probs), mask=mask, pad_value=pad_value))
    out = ctc.ctc_greedy_decode(torch.from_numpy(probs),
                                mask=None if mask is None else torch.from_numpy(mask),
                                pad_value=pad_value).numpy()
    np.testing.assert_array_equal(out, ref)
    assert (out == pad_value).any() and (out >= 0).any()


def test_ctc_greedy_decode_rejects_nonnegative_pad():
    with pytest.raises(ValueError, match="pad_value"):
        ctc.ctc_greedy_decode(torch.zeros(1, 3, 4), pad_value=0)


def _batch(seed=0, size=4, weights=None):
    """A get_batch_generator-style batch of random crops and labels."""
    rng = np.random.RandomState(seed)
    images = rng.rand(size, 31, 64, 1).astype(np.float32)
    label_length = rng.randint(1, 6, size=(size, 1))
    labels = np.full((size, FRAMES), -1, np.int64)
    for i, n in enumerate(label_length[:, 0]):
        labels[i, :n] = rng.randint(0, len(ALPHABET), size=n)
    input_length = np.full((size, 1), FRAMES, dtype=np.float64)
    batch = ((images, labels, input_length, label_length), np.zeros((size, 1)))
    return batch if weights is None else batch + (np.asarray(weights, np.float32),)


_JAX_RECOGNIZERS = {}


def _jax_recognizer(stn):
    """The JAX recognizer of the tiny CRNN (built once per ``stn``) and a
    fresh numpy copy of its initial variables."""
    if stn not in _JAX_RECOGNIZERS:
        recognizer = JaxRecognizer(ALPHABET, None, dict(TINY_CRNN, stn=stn))
        variables = jax.tree.map(np.asarray, recognizer.variables)
        if stn:
            # Turn the localisation net on: a zero kernel passes no gradient up.
            dense2 = variables["params"]["stn"]["dense2"]
            dense2["kernel"] = np.random.RandomState(5).randn(
                *dense2["kernel"].shape).astype(np.float32) * 0.01
        _JAX_RECOGNIZERS[stn] = recognizer, variables
    recognizer, variables = _JAX_RECOGNIZERS[stn]
    return recognizer, jax.tree.map(np.copy, variables)


def _port_recognizer(variables, stn=False, **build):
    params = dict(TINY_CRNN, stn=stn, **build)
    return Recognizer(ALPHABET, None, params, device="cpu").load_variables(variables)


@pytest.fixture(scope="module", params=[False, True], ids=["stn_off", "stn_on"])
def crnn_step(request):
    """One JAX training step's logits, loss, gradients and running
    statistics, from a variable tree both packages load."""
    stn = request.param
    recognizer, variables = _jax_recognizer(stn)
    (images, labels, input_length, label_length), _ = _batch()
    sample_weights = np.array([1.0, 0.5, 2.0, 1.0], np.float32)

    def loss_fn(params):
        logits, updates = recognizer.model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, images, train=True,
            return_logits=True, mutable=["batch_stats"])
        losses = jctc.ctc_loss(logits, labels, input_length.reshape(-1).astype(np.int32),
                               label_length.reshape(-1))
        return jnp.mean(losses * sample_weights), (logits, updates["batch_stats"])

    (loss, (logits, stats)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])
    return {"stn": stn, "variables": variables, "weights": sample_weights,
            "loss": float(loss), "logits": np.asarray(logits),
            "grads": jax.tree.map(np.asarray, grads), "stats": jax.tree.map(np.asarray, stats)}


def _leaves(tree, prefix=""):
    for key, value in sorted(tree.items()):
        if isinstance(value, dict):
            yield from _leaves(value, f"{prefix}{key}/")
        else:
            yield f"{prefix}{key}", np.asarray(value)


def _gradient_tree(model):
    """The model's gradients in the JAX tree layout (zeros where a
    parameter is frozen), through the weight bridge."""
    state = dict(model.state_dict())
    for name, param in model.named_parameters():
        state[name] = param.grad if param.grad is not None else torch.zeros_like(param)
    return weights.crnn_variables(state)["params"]


def _assert_leaves_close(ours, ref, bar, what):
    ours, ref = dict(_leaves(ours)), dict(_leaves(ref))
    assert ours.keys() == ref.keys()
    for path, value in ref.items():
        err = np.abs(ours[path] - value).max()
        assert err <= bar * max(np.abs(value).max(), 1e-12), (what, path, err)


def test_crnn_train_step_matches_jax(crnn_step):
    recognizer = _port_recognizer(crnn_step["variables"], stn=crnn_step["stn"])
    images = torch.from_numpy(_batch()[0][0])
    recognizer.model.train()
    with torch.no_grad():
        logits = recognizer.model(images, return_logits=True).numpy()
    np.testing.assert_allclose(logits, crnn_step["logits"], rtol=0, atol=1e-4)
    recognizer.load_variables(crnn_step["variables"])  # undo the statistics update

    trainer = RecognizerTrainer(recognizer)
    loss = trainer.train_step(_batch(weights=crnn_step["weights"]))
    assert abs(loss - crnn_step["loss"]) <= 1e-5 * abs(crnn_step["loss"])
    _assert_leaves_close(_gradient_tree(recognizer.model), crnn_step["grads"], 1e-4, "grad")
    _assert_leaves_close(trainer.variables["batch_stats"], crnn_step["stats"], 1e-5, "stats")
    assert not recognizer.model.training


@pytest.mark.parametrize("name", ["rmsprop", "adam"])
def test_optimizer_matches_optax(name):
    """Three steps on identical gradients, some below 1e-4, from identical
    parameters."""
    rng = np.random.RandomState(2)
    start = rng.randn(64).astype(np.float32)
    grads = [rng.randn(64).astype(np.float32) * scale for scale in (1.0, 1e-5, 3e-3)]
    grads[0][:8] *= 1e-5
    transform = optax.rmsprop(1e-3) if name == "rmsprop" else optax.adam(1e-3)
    params = jnp.asarray(start)
    state = transform.init(params)
    param = torch.nn.Parameter(torch.from_numpy(start.copy()))
    optimizer = RMSprop([param], lr=1e-3) if name == "rmsprop" else adam([param], lr=1e-3)
    for grad in grads:
        updates, state = transform.update(jnp.asarray(grad), state, params)
        params = optax.apply_updates(params, updates)
        param.grad = torch.from_numpy(grad)
        optimizer.step()
        np.testing.assert_allclose(param.detach().numpy(), np.asarray(params), rtol=0,
                                   atol=1e-6)


@pytest.fixture(scope="module")
def jax_trajectory():
    """Three JAX trainer steps (one-device mesh) on one batch; the start
    and end variables."""
    recognizer, variables = _jax_recognizer(stn=False)
    recognizer.variables = jax.tree.map(jnp.asarray, variables)
    trainer = JaxRecognizerTrainer(recognizer, mesh=mesh_lib.create_mesh(
        devices=jax.devices()[:1]))
    batch = _batch(seed=3)
    losses = [trainer.train_step(batch, jax.random.PRNGKey(0)) for _ in range(3)]
    return {"start": variables, "losses": losses, "recognizer": recognizer,
            "end": jax.tree.map(np.asarray, trainer.variables)}


def test_trainer_loss_trajectory_matches_jax(jax_trajectory):
    trainer = RecognizerTrainer(_port_recognizer(jax_trajectory["start"]))
    losses = [trainer.train_step(_batch(seed=3)) for _ in range(3)]
    np.testing.assert_allclose(losses, jax_trajectory["losses"], rtol=1e-4)
    assert losses[-1] < losses[0]


def _crops(count=6, seed=4):
    return np.random.RandomState(seed).rand(count, 31, 64, 1).astype(np.float32)


def test_checkpoint_from_jax_reads_the_same_strings(jax_trajectory, tmp_path):
    """A JAX checkpoint (``save_npz``) restored into a port Recognizer."""
    path = jcheckpoint.save_npz(os.path.join(tmp_path, "jax.npz"), jax_trajectory["end"])
    recognizer = _port_recognizer(checkpoint.restore_npz(path))
    jax_trajectory["recognizer"].variables = jax.tree.map(jnp.asarray, jax_trajectory["end"])
    expected = jax_trajectory["recognizer"]._predict_strings(_crops())
    assert any(expected)
    assert recognizer._predict_strings(_crops()) == expected


def test_checkpoint_to_jax_reads_the_same_strings(jax_trajectory, tmp_path):
    """A port checkpoint (after steps of the port's trainer) restored by
    ``keras_ocr_tpu.train.checkpoint.restore_npz`` into a JAX Recognizer;
    ``save`` / ``restore`` / ``latest`` both ways."""
    trainer = RecognizerTrainer(_port_recognizer(jax_trajectory["start"]))
    for seed in range(2):
        trainer.train_step(_batch(seed=seed))
    path = checkpoint.save_npz(os.path.join(tmp_path, "port.npz"), trainer.variables)
    jax_recognizer = jax_trajectory["recognizer"]
    jax_recognizer.variables = jax.tree.map(jnp.asarray, jcheckpoint.restore_npz(path))
    expected = trainer.recognizer._predict_strings(_crops())
    assert any(expected)
    assert jax_recognizer._predict_strings(_crops()) == expected

    saved = checkpoint.save(os.path.join(tmp_path, "ckpt", "step-2"), trainer.variables)
    assert saved.endswith(".npz") and checkpoint.latest(os.path.join(tmp_path, "ckpt")) == saved
    for restored in (checkpoint.restore(saved[: -len(".npz")]), jcheckpoint.restore(saved)):
        ours, theirs = dict(_leaves(trainer.variables)), dict(_leaves(restored))
        assert ours.keys() == theirs.keys()
        assert all(np.array_equal(ours[k], np.asarray(theirs[k])) for k in ours)


@pytest.mark.parametrize("stn", [False, True])
def test_bridge_round_trip_is_the_identity(stn):
    _, variables = _jax_recognizer(stn)
    back = _port_recognizer(variables, stn=stn)
    tree = weights.crnn_variables(back.model)
    ours, ref = dict(_leaves(tree)), dict(_leaves(variables))
    assert ours.keys() == ref.keys()
    for path, value in ref.items():
        assert ours[path].dtype == value.dtype and np.array_equal(ours[path], value), path
    # Numpy copies: training the model does not change a tree taken before.
    with torch.no_grad():
        back.model.fc_12.bias.add_(1.0)
    assert np.array_equal(tree["params"]["fc_12"]["bias"], variables["params"]["fc_12"]["bias"])


def test_dropout_in_training_mode():
    """About a quarter of the features zeroed, survivors scaled by 1/(1-p),
    the same mask for the same generator seed, the identity in eval mode,
    and no mask without a generator."""
    _, variables = _jax_recognizer(stn=False)
    model = _port_recognizer(variables, dropout=0.25).model
    seen = []
    model.fc_12.register_forward_pre_hook(lambda module, args: seen.append(args[0]))
    images = torch.from_numpy(_crops(count=8))
    with torch.no_grad():
        evaluated_features = model(images, return_backbone=True)
        model(images)
        model.train()  # batch statistics: other features
        features = model(images, return_backbone=True)
        for _ in range(2):
            model(images, generator=torch.Generator().manual_seed(7))
        model(images, generator=torch.Generator().manual_seed(8))
    evaluated, first, again, other = seen
    assert torch.equal(evaluated, evaluated_features)
    dropped = first == 0
    assert 0.2 < dropped.float().mean().item() < 0.3
    torch.testing.assert_close(first[~dropped], features[~dropped] / 0.75, rtol=1e-6, atol=0)
    assert torch.equal(first, again) and not torch.equal(first, other)
    with pytest.raises(ValueError, match="Generator"):
        model(images)


def test_fit_with_callbacks(jax_trajectory, tmp_path):
    """Epoch 0 is the best (later epochs weigh their samples 100x):
    EarlyStopping stops after ``patience`` worse epochs and restores
    epoch 0's variables, ModelCheckpoint saved only them, CSVLogger wrote a
    row per epoch."""
    recognizer = _port_recognizer(jax_trajectory["start"])
    trainer = recognizer.compile(learning_rate=1e-3)
    assert recognizer.trainer is trainer and isinstance(trainer.optimizer, RMSprop)

    def batches():
        for epoch in range(100):
            yield _batch(seed=epoch, weights=[1.0 if epoch == 0 else 100.0] * 4)

    stopper = EarlyStopping(patience=2, restore_best_weights=True)
    saver = ModelCheckpoint(os.path.join(tmp_path, "best"))
    log = os.path.join(tmp_path, "log.csv")
    history = trainer.fit(batches(), steps_per_epoch=1, epochs=6,
                          callbacks=[stopper, saver, CSVLogger(log)], seed=1)
    assert len(history) == 3 and history[0] < min(history[1:])
    assert not recognizer.model.training
    best = dict(_leaves(stopper.best_variables))
    for tree in (trainer.variables, checkpoint.restore(os.path.join(tmp_path, "best"))):
        leaves = dict(_leaves(tree))
        assert leaves.keys() == best.keys()
        assert all(np.array_equal(leaves[k], best[k]) for k in best)
    with open(log, newline="") as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["epoch", "loss"] and [int(r[0]) for r in rows[1:]] == [0, 1, 2]
    np.testing.assert_allclose([float(r[1]) for r in rows[1:]], history, rtol=1e-12)


def test_multi_device_arguments_and_missing_card_raise():
    _, variables = _jax_recognizer(stn=False)
    recognizer = _port_recognizer(variables)
    with pytest.raises(NotImplementedError, match="mesh"):
        RecognizerTrainer(recognizer, mesh=object())
    with pytest.raises(NotImplementedError, match="tensor_parallel"):
        RecognizerTrainer(recognizer, tensor_parallel=True)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            RecognizerTrainer(Recognizer())


def test_pipeline_reads_with_the_trained_weights():
    """Training a golden pipeline's models in place changes what the
    pipeline reads, and it reads what a pipeline loaded with the trainers'
    variables reads."""
    pipeline = golden.load_golden_pipeline(GOLDEN, device="cpu")[0]
    scene = [os.path.join(GOLDEN, "scene_00.png")]
    before = pipeline.recognize(scene)
    detector_trainer = pipeline.detector.compile(learning_rate=1e-4)
    rng = np.random.RandomState(6)
    images = rng.rand(2, 256, 320, 3).astype(np.float32)
    targets = (rng.rand(2, 128, 160, 2) * 0.5).astype(np.float32)
    detector_trainer.train_step((images, targets))
    recognizer = pipeline.recognizer
    trainer = recognizer.compile(learning_rate=1e-2)
    frames = recognizer.max_string_length()
    crops = rng.rand(4, 31, 200, 1).astype(np.float32)
    labels = np.full((4, frames), -1)
    labels[:, :3] = rng.randint(0, 36, size=(4, 3))
    trainer.train_step(((crops, labels, np.full((4, 1), frames), np.full((4, 1), 3)),
                        np.zeros((4, 1))))
    after = pipeline.recognize(scene)

    fresh = golden.load_golden_pipeline(GOLDEN, device="cpu")[0]
    fresh.detector.load_variables(detector_trainer.variables)
    fresh.recognizer.load_variables(trainer.variables)
    expected = fresh.recognize(scene)

    def words(results):
        return [[word for word, _ in image] for image in results]

    assert words(after) != words(before)
    assert words(after) == words(expected)
    for (_, box), (_, ref) in zip(after[0], expected[0]):
        np.testing.assert_array_equal(box, ref)
