"""Port parity of bfloat16 training on the CPU: one step of the port's
``RecognizerTrainer`` / ``DetectorTrainer`` on a ``compute_dtype=bfloat16``
model (float32 parameters) against the JAX trainer's own step on the same
model, weights and batch, applied op by op (``jax.disable_jit()``), as the
other parity tests apply the JAX modules. The models: the tiny CRNN of
``tests/test_torch_train_recognizer.py`` with the STN off and on, and the
VGG CRAFT at width 0.25 on a (2, 64, 96) batch. Also the bf16 step on two
CPU devices (data parallel, both trainers; the CRNN's tensor parallel)
against the one-device bf16 step, ``compile()`` and a checkpoint round
trip of bf16 models (VGG and B0 detectors, the recognizer).

The floor and the bars (``scripts/bf16_train_parity_cpu.py`` prints every
number; PERF.md §6, PR 16). The measure is per gradient leaf, the relative
L2 error ||port - JAX|| / ||JAX||; the issue's max-relative error
(max |port - JAX| / max |JAX|) is printed beside it:

- Floor: JAX's jitted step against its op-by-op step. Worst leaf, max-rel /
  L2: CRNN 3.2e-2 / 3.5e-2, with the STN 9.7e-2 / 7.6e-2, CRAFT 0.56 /
  0.33 (leaves that are zero in exact arithmetic left out). A bf16 CRAFT
  gradient at initialisation is mostly rounding noise: each BatchNorm's
  backward subtracts the batch means of its incoming gradient, which a
  bf16 rounding of that gradient already blurs, and 25 of them compound.
- JAX's float32 step against its bf16 step: worst leaf 0.60 / 0.60, 1.19 /
  0.80, 0.91 / 0.68. The port's own float32 step sits as far.
- The bar: GRAD_BAR = 0.5 on the L2 measure, at most 2x the worst floor
  (0.67) and below each model's float32 distance (0.60 and up), so a step
  that ran in float32 fails it; the test checks that the port's float32
  step does. The port sits at 0.31 / 0.29 / 0.46 (CRNN leaves at 0.3 are
  conv biases: XLA:CPU sums the transpose of a bf16 bias broadcast in bf16,
  one element after another, where the port sums in float32). On the
  max-relative measure no bar meets both conditions: CRAFT's floor (0.56)
  doubled passes its float32 distance (0.91).
- Leaves zero in exact arithmetic (a conv bias that a BatchNorm follows,
  read off the port's float32 step): below ZERO_BAR = 3.3e-2 of the
  model's largest gradient, 2x JAX's own bf16 noise there (1.6e-2; the
  port's 9.7e-4).
- Running statistics after the step, per leaf relative L2: STATS_BAR =
  6.8e-3, at most 2x the floor (3.4e-3); the port 5.8e-3, float32 CRAFT
  1.4e-2.
- The loss: LOSS_BAR = 1e-3 relative. It is the training forward's, which
  at random initialisation sits a mean 2.2e-3 from JAX's heatmaps (JAX's
  float32 4.6e-3): the port's CRAFT loss is 5.7e-4 off, as far as the
  float32 step's (6.2e-4), where JAX's jit and op-by-op agree to 3.7e-5.
  The gradient bar, not the loss, tells float32 from bf16.

The JAX steps run op by op (about 70 s here for the two CRNNs; CRAFT's,
about 90 s, and its tests are in ``tests/test_torch_train_detector.py``);
they are module fixtures.
"""

import functools
import string
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from keras_ocr_tpu.detection import Detector as JaxDetector
from keras_ocr_tpu.parallel import mesh as jmesh
from keras_ocr_tpu.recognition import Recognizer as JaxRecognizer
from keras_ocr_tpu.train import DetectorTrainer as JaxDetectorTrainer
from keras_ocr_tpu.train import RecognizerTrainer as JaxRecognizerTrainer
from keras_ocr_tpu_torch import Detector, Recognizer, weights
from keras_ocr_tpu_torch.parallel import mesh as mesh_lib
from keras_ocr_tpu_torch.train import DetectorTrainer, RecognizerTrainer, checkpoint

torch.set_num_threads(2)

GRAD_BAR = 0.5
ZERO_BAR = 3.3e-2
STATS_BAR = 6.8e-3
LOSS_BAR = 1e-3
CPU = torch.device("cpu")

TINY_CRNN = {
    "height": 31, "width": 64, "color": False, "filters": (8, 8, 8, 8, 16, 16, 16),
    "rnn_units": (16, 16), "dropout": 0.0, "rnn_steps_to_discard": 2, "pool_size": 2,
    "stn": False,
}
ALPHABET = string.ascii_lowercase[:8]
FRAMES = 64 // 4 - 2
CRAFT_WIDTH = 0.25
CRAFT_SHAPE = (2, 64, 96)


def recording():
    """An optax transform whose state is the last gradient and whose update
    is zero: the JAX trainers' own steps then return their gradients."""
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda grads, state, params=None: (jax.tree.map(jnp.zeros_like, grads), grads))


def crnn_batch(seed=0, size=4):
    """A ``get_batch_generator``-style batch of random crops and labels,
    with sample weights."""
    rng = np.random.RandomState(seed)
    images = rng.rand(size, 31, 64, 1).astype(np.float32)
    label_length = rng.randint(1, 6, size=(size, 1))
    labels = np.full((size, FRAMES), -1, np.int64)
    for i, n in enumerate(label_length[:, 0]):
        labels[i, :n] = rng.randint(0, len(ALPHABET), size=n)
    input_length = np.full((size, 1), FRAMES, dtype=np.float64)
    sample_weights = np.array([1.0, 0.5, 2.0, 1.0] * (size // 4 + 1), np.float32)[:size]
    return (images, labels, input_length, label_length), np.zeros((size, 1)), sample_weights


def craft_batch(seed=0):
    """Normalised images and targets with text and link blobs."""
    rng = np.random.RandomState(seed)
    batch, height, width = CRAFT_SHAPE
    images = rng.randn(batch, height, width, 3).astype(np.float32)
    targets = (rng.rand(batch, height // 2, width // 2, 2) * 0.05).astype(np.float32)
    targets[0, 6:14, 4:20, 0] = rng.uniform(0.3, 1.0, (8, 16))
    targets[0, 8:12, 10:26, 1] = rng.uniform(0.3, 1.0, (4, 16))
    targets[1, 20:28, 12:40, 0] = rng.uniform(0.3, 1.0, (8, 28))
    return images, targets, np.array([1.0, 0.5], np.float32)


@functools.lru_cache(maxsize=None)
def crnn_variables(stn):
    """The tiny CRNN's initial variables (numpy, shared: not to be written),
    the STN's localisation net turned on (a zero kernel passes no gradient
    up)."""
    variables = jax.tree.map(np.asarray, JaxRecognizer(ALPHABET, None,
                                                       dict(TINY_CRNN, stn=stn)).variables)
    if stn:
        dense2 = variables["params"]["stn"]["dense2"]
        dense2["kernel"] = np.random.RandomState(5).randn(
            *dense2["kernel"].shape).astype(np.float32) * 0.01
    return variables


@functools.lru_cache(maxsize=None)
def craft_variables():
    return jax.tree.map(np.asarray, JaxDetector(weights=None, width=CRAFT_WIDTH,
                                                max_components=16).variables)


def _jax_step(trainer, variables, batch_args, eager):
    """One step of a JAX trainer from ``variables``: its own ``jax.jit``
    of ``_train_step``, or ``_train_step`` op by op (``eager``)."""
    variables = jax.tree.map(jnp.array, variables)
    opt_state = trainer.optimizer.init(variables["params"])
    if eager:
        with jax.disable_jit():
            out, grads, loss = trainer._train_step(variables, opt_state, *batch_args)
    else:
        out, grads, loss = trainer._step(variables, opt_state, *batch_args)
    return {"loss": float(loss), "grads": jax.tree.map(np.asarray, grads),
            "stats": jax.tree.map(np.asarray, out["batch_stats"])}


def _one_device():
    return jmesh.create_mesh(devices=jax.devices()[:1])


def jax_crnn_step(variables, stn, dtype=jnp.bfloat16, eager=True):
    """The JAX recognizer trainer's step on the tiny CRNN."""
    (images, labels, input_length, label_length), _, sample_weights = crnn_batch()
    batch = (jnp.asarray(images, jnp.float32), jnp.asarray(labels, jnp.int32),
             jnp.asarray(input_length, jnp.int32), jnp.asarray(label_length, jnp.int32),
             jnp.asarray(sample_weights))
    recognizer = JaxRecognizer(ALPHABET, None, dict(TINY_CRNN, stn=stn), dtype)
    trainer = JaxRecognizerTrainer(recognizer, recording(), _one_device())
    return _jax_step(trainer, variables, (batch, jax.random.PRNGKey(0)), eager)


def jax_craft_step(variables, dtype=jnp.bfloat16, eager=True):
    """The JAX detector trainer's step on the VGG CRAFT."""
    batch = tuple(jnp.asarray(a, jnp.float32) for a in craft_batch())
    detector = JaxDetector(weights=None, width=CRAFT_WIDTH, max_components=16,
                           compute_dtype=dtype)
    trainer = JaxDetectorTrainer(detector, recording(), _one_device())
    return _jax_step(trainer, variables, (batch,), eager)


def _frozen(params):
    """An optimiser that moves nothing: the step leaves its gradients in
    ``.grad``."""
    return torch.optim.SGD(params, lr=0.0)


def _gradients(model, to_tree):
    state = dict(model.state_dict())
    for name, param in model.named_parameters():
        state[name] = param.grad if param.grad is not None else torch.zeros_like(param)
    return to_tree(state)["params"]


def port_crnn_step(variables, stn, dtype=torch.bfloat16, **trainer_kwargs):
    """The port's recognizer trainer's step on the tiny CRNN."""
    recognizer = Recognizer(ALPHABET, None, dict(TINY_CRNN, stn=stn), dtype,
                            device="cpu").load_variables(variables)
    trainer = RecognizerTrainer(recognizer, _frozen, **trainer_kwargs)
    loss = trainer.train_step(crnn_batch())
    return {"loss": loss, "grads": _gradients(recognizer.model, weights.crnn_variables),
            "stats": trainer.variables["batch_stats"], "trainer": trainer}


def port_craft_step(variables, dtype=torch.bfloat16, **trainer_kwargs):
    """The port's detector trainer's step on the VGG CRAFT."""
    detector = Detector(weights=None, width=CRAFT_WIDTH, compute_dtype=dtype,
                        device="cpu").load_variables(variables)
    trainer = DetectorTrainer(detector, _frozen, **trainer_kwargs)
    loss = trainer.train_step(craft_batch())
    return {"loss": loss, "grads": _gradients(detector.model, weights.craft_variables),
            "stats": trainer.variables["batch_stats"], "trainer": trainer}


def leaves(tree, prefix=""):
    for key, value in sorted(tree.items()):
        if isinstance(value, dict):
            yield from leaves(value, f"{prefix}{key}/")
        else:
            yield f"{prefix}{key}", np.asarray(value, np.float64)


def max_relative(out, ref):
    """Per leaf: max |out - ref| / max(max |ref|, 1e-12)."""
    out, ref = dict(leaves(out)), dict(leaves(ref))
    assert out.keys() == ref.keys(), sorted(set(out) ^ set(ref))
    return {path: float(np.abs(out[path] - value).max() / max(np.abs(value).max(), 1e-12))
            for path, value in ref.items()}


def l2_relative(out, ref):
    """Per leaf: ||out - ref|| / max(||ref||, 1e-12), over the leaf's
    elements."""
    out, ref = dict(leaves(out)), dict(leaves(ref))
    assert out.keys() == ref.keys(), sorted(set(out) ^ set(ref))
    return {path: float(np.linalg.norm(out[path] - value) / max(np.linalg.norm(value), 1e-12))
            for path, value in ref.items()}


def zero_leaves(grads):
    """The leaves whose gradient is zero in exact arithmetic, read off a
    float32 step: below 1e-4 of the model's largest (a conv bias that a
    BatchNorm follows, and what reaches a BatchNorm as a per-channel
    constant)."""
    tree = dict(leaves(grads))
    largest = max(np.abs(value).max() for value in tree.values())
    return {path for path, value in tree.items() if np.abs(value).max() <= 1e-4 * largest}


def assert_step_close(step, ref, zero, what):
    """``step`` within the bars of ``ref``: the loss, each gradient leaf
    (those in ``zero`` held to rounding noise) and the running statistics."""
    assert abs(step["loss"] - ref["loss"]) <= LOSS_BAR * abs(ref["loss"]), (what, step["loss"])
    grads = l2_relative(step["grads"], ref["grads"])
    largest = max(np.abs(value).max() for _, value in leaves(ref["grads"]))
    ours = dict(leaves(step["grads"]))
    for path, err in grads.items():
        if path in zero:
            assert np.abs(ours[path]).max() <= ZERO_BAR * largest, (what, path)
        else:
            assert err <= GRAD_BAR, (what, path, err)
    for path, err in l2_relative(step["stats"], ref["stats"]).items():
        assert err <= STATS_BAR, (what, path, err)


def assert_float32_state(step):
    """Parameters, gradients and running statistics stay float32."""
    trainer = step["trainer"]
    for name, param in trainer.model.named_parameters():
        assert param.dtype == torch.float32, name
        assert param.grad is None or param.grad.dtype == torch.float32, name
    assert {b.dtype for n, b in trainer.model.named_buffers()
            if not n.endswith("num_batches_tracked")} == {torch.float32}
    assert not trainer.model.training


@pytest.fixture(scope="module", params=[False, True], ids=["stn_off", "stn_on"])
def crnn_case(request):
    stn = request.param
    variables = crnn_variables(stn)
    return {"stn": stn, "variables": variables, "jax": jax_crnn_step(variables, stn),
            "float32": port_crnn_step(variables, stn, torch.float32)}


def check_against_jax(case, step):
    zero = zero_leaves(case["float32"]["grads"])
    assert_float32_state(step)
    assert_step_close(step, case["jax"], zero, "bf16 step")
    # The bar tells a step that ran in float32 from a bf16 one.
    distances = l2_relative(case["float32"]["grads"], case["jax"]["grads"])
    assert max(err for path, err in distances.items() if path not in zero) > GRAD_BAR


def test_crnn_bf16_step_matches_jax(crnn_case):
    step = port_crnn_step(crnn_case["variables"], crnn_case["stn"])
    assert step["trainer"].recognizer.model.dtype == torch.bfloat16
    check_against_jax(crnn_case, step)


@pytest.mark.parametrize("case", ["data_parallel", "tensor_parallel"])
def test_crnn_bf16_step_on_a_mesh_matches_one_device(case):
    """Two CPU devices: the batch split over ``data`` (BatchNorm's sums in
    float32 across the shards), or the CRNN's kernels split by columns
    over ``model``; against the one-device bf16 step of the STN-off CRNN."""
    variables = crnn_variables(False)
    one = port_crnn_step(variables, False)
    if case == "data_parallel":
        step = port_crnn_step(variables, False, mesh=mesh_lib.create_mesh(devices=[CPU] * 2))
    else:
        step = port_crnn_step(variables, False, tensor_parallel=True,
                              mesh=mesh_lib.create_mesh((1, 2), devices=[CPU] * 2))
    assert_float32_state(step)
    zero = zero_leaves(port_crnn_step(variables, False, torch.float32)["grads"])
    assert_step_close(step, one, zero, case)


@pytest.fixture
def offline(tmp_path, monkeypatch):
    """No network, and empty vendored and cache directories (the B0
    detector looks up its ImageNet weights and keeps a random backbone)."""

    def refuse(*args, **kwargs):
        raise OSError("no network in the tests")

    monkeypatch.setattr(urllib.request, "urlopen", refuse)
    monkeypatch.setenv("KERAS_OCR_TPU_VENDORED_WEIGHTS", str(tmp_path / "vendored"))
    monkeypatch.setenv("KERAS_OCR_TPU_CACHE_DIR", str(tmp_path / "cache"))
    monkeypatch.delenv("KERAS_OCR_TPU_WEIGHTS_MIRROR", raising=False)
    return tmp_path


def _bf16_model(kind):
    if kind == "recognizer":
        return Recognizer(ALPHABET, None, TINY_CRNN, torch.bfloat16, device="cpu")
    if kind == "vgg":
        return Detector(weights=None, width=0.125, compute_dtype=torch.bfloat16, device="cpu")
    with pytest.warns(UserWarning):
        return Detector(weights=None, backbone_name="efficientnetb0",
                        compute_dtype=torch.bfloat16, device="cpu")


@pytest.mark.parametrize("kind", ["recognizer", "vgg", "efficientnetb0"])
def test_bf16_model_compiles_trains_and_checkpoints(kind, offline):
    """``compile()`` of a bf16 model, two ``fit`` steps with the default
    optimiser (its state float32), then ``save_npz`` / ``restore_npz`` into
    a fresh bf16 model: the float32 variables come back bit for bit."""
    model = _bf16_model(kind)
    trainer = model.compile()
    if kind == "recognizer":
        batches = iter([crnn_batch(seed) for seed in range(2)])
    else:
        rng = np.random.RandomState(0)
        batches = iter([(rng.randn(2, 64, 64, 3).astype(np.float32),
                         rng.rand(2, 32, 32, 2).astype(np.float32)) for _ in range(2)])
    history = trainer.fit(batches, steps_per_epoch=2)
    assert np.isfinite(history).all()
    assert_float32_state({"trainer": trainer})
    state = [t for per_param in trainer.optimizer.state.values() for t in per_param.values()
             if torch.is_tensor(t) and t.dim() > 0]
    assert state and {t.dtype for t in state} == {torch.float32}
    path = checkpoint.save_npz(str(offline / "bf16.npz"), trainer.variables)
    fresh = _bf16_model(kind).load_variables(checkpoint.restore_npz(path))
    assert fresh.model.dtype == torch.bfloat16
    ours, ref = dict(leaves(_variables(fresh))), dict(leaves(trainer.variables))
    assert ours.keys() == ref.keys()
    for key, value in ref.items():
        np.testing.assert_array_equal(ours[key], value, err_msg=key)


def _variables(model):
    if isinstance(model, Recognizer):
        return weights.crnn_variables(model.model)
    return weights.craft_variables(model.model)
