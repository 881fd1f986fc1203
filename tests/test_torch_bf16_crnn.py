"""Port parity of the bfloat16 CRNN on the CPU: the same weights and seeded
crops through the JAX module with ``dtype=jnp.bfloat16`` (applied op by op,
as the other parity tests apply it) and the port's with
``dtype=torch.bfloat16``, on the golden checkpoint and at the production
filters with a non-identity STN.

Bars: the softmax within 2e-2 absolute, mean 1e-3; the greedy-decoded
strings equal, except at frames where JAX's bfloat16 top two probabilities
lie within 1e-2 of each other (those frames are counted). The port's LSTMs
are ``nn.LSTM`` with bf16 weights (cuDNN on the card); the JAX package's
rounding step by step (``models.crnn.bilstm_steps``) is held to the same
bars. The STN samples in float32 in both (theta, grid and taps), the logits
and the softmax are float32, and the parameters stay float32.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keras_ocr_tpu.recognition import Recognizer as JaxRecognizer
from keras_ocr_tpu.train.checkpoint import restore_npz
from keras_ocr_tpu_torch import weights
from keras_ocr_tpu_torch.models import CRNN, crnn

torch.set_num_threads(2)

GOLDEN = os.path.join(os.path.dirname(__file__), "fixtures", "golden_offline")
with open(os.path.join(GOLDEN, "meta.json"), encoding="utf8") as _f:
    META = json.load(_f)
CRNN_KEYS = ("height", "width", "color", "filters", "rnn_units", "dropout",
             "rnn_steps_to_discard", "pool_size", "stn")


def _numpy_tree(variables):
    return jax.tree.map(np.asarray, variables)


def _errors(out, ref):
    err = np.abs(np.asarray(out, np.float64) - np.asarray(ref, np.float64))
    return float(err.max()), float(err.mean())


def _greedy(probs):
    """Greedy CTC strings of (B, T, classes) frames (blank = last class)."""
    blank = probs.shape[-1] - 1
    strings = []
    for frames in probs.argmax(-1):
        kept = [int(c) for i, c in enumerate(frames)
                if c != blank and (i == 0 or c != frames[i - 1])]
        strings.append(kept)
    return strings


def _assert_crnn_bars(out, ref):
    """Softmax within 2e-2 (mean 1e-3); decoded strings equal but where
    JAX's top two probabilities are within 1e-2; returns the number of
    such near-tie frames whose argmax differs."""
    assert out.shape == ref.shape
    worst, mean = _errors(out, ref)
    assert worst <= 2e-2, worst
    assert mean <= 1e-3, mean
    top2 = np.sort(ref, -1)[..., -2:]
    near_tie = top2[..., 1] - top2[..., 0] < 1e-2
    moved = out.argmax(-1) != ref.argmax(-1)
    assert not (moved & ~near_tie).any()
    if not moved.any():
        assert _greedy(out) == _greedy(ref)
    return int(moved.sum())


def _perturb_stn(variables, seed):
    rng = np.random.RandomState(seed)
    dense2 = variables["params"]["stn"]["dense2"]
    dense2["kernel"] = (rng.randn(*dense2["kernel"].shape) * 0.02).astype(np.float32)
    dense2["bias"] = np.array([0.9, 0.08, 0.05, -0.06, 1.1, 0.03], np.float32)
    return variables


@pytest.mark.parametrize("shape", ["golden_slim", "production"])
def test_crnn_bf16_matches_flax(shape):
    if shape == "golden_slim":
        build_params = dict(META["recognizer_build_params"])
        variables = restore_npz(os.path.join(GOLDEN, "recognizer_slim.npz"))
        batch = 4
    else:
        recognizer = JaxRecognizer(weights=None, alphabet=META["alphabet"])
        build_params = dict(recognizer.build_params)
        assert build_params["stn"] and build_params["filters"][-1] == 512
        variables = _perturb_stn(_numpy_tree(recognizer.variables), seed=0)
        batch = 2
    jax_recognizer = JaxRecognizer(alphabet=META["alphabet"], weights=None,
                                   build_params=build_params, compute_dtype=jnp.bfloat16)
    x = np.random.RandomState(0).rand(batch, build_params["height"], build_params["width"],
                                      1).astype(np.float32)
    ref = np.asarray(jax_recognizer.model.apply(variables, jnp.asarray(x), train=False))
    model = CRNN(alphabet_size=len(META["alphabet"]), dtype=torch.bfloat16,
                 **{k: build_params[k] for k in CRNN_KEYS})
    model.load_state_dict(weights.crnn_state_dict(variables))
    model.eval()
    with torch.no_grad():
        out = model(torch.from_numpy(x))
        # The JAX package's own rounding, step by step, against the same bars.
        model._bilstm = lambda lstm, h: crnn.bilstm_steps(lstm, h)
        steps = model(torch.from_numpy(x)).numpy()
    assert out.dtype == torch.float32
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    _assert_crnn_bars(out.numpy(), ref)
    _assert_crnn_bars(steps, ref)
