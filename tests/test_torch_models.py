"""Port parity: CRAFT and CRNN vs the Flax modules, same weights.

Weights come from the JAX package (its random init, or the golden
artifact's trained checkpoints) through the port's weight bridge. CRAFT is
held to 1e-4 in float32 (standard and BN-folded graphs), the CRNN's
softmax to 1e-5, both at the golden artifact's slim shapes and at the
production shapes; the port's BatchNorm fold to 1e-6 against the JAX
package's.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keras_ocr_tpu.detection import Detector as JaxDetector
from keras_ocr_tpu.recognition import Recognizer as JaxRecognizer
from keras_ocr_tpu.train.checkpoint import restore_npz
from keras_ocr_tpu_torch import weights
from keras_ocr_tpu_torch.detection import Detector
from keras_ocr_tpu_torch.models import CRAFT, CRNN, init_parameters
from keras_ocr_tpu_torch.models.craft import fold_bn_state_dict
from keras_ocr_tpu_torch.weights import read_npz

torch.set_num_threads(2)

GOLDEN = os.path.join(os.path.dirname(__file__), "fixtures", "golden_offline")
with open(os.path.join(GOLDEN, "meta.json"), encoding="utf8") as _f:
    META = json.load(_f)


def _numpy_tree(variables):
    return jax.tree.map(np.asarray, variables)


def _crnn_from(build_params, variables, alphabet_size=36):
    keys = ("height", "width", "color", "filters", "rnn_units", "dropout",
            "rnn_steps_to_discard", "pool_size", "stn")
    model = CRNN(alphabet_size=alphabet_size, **{k: build_params[k] for k in keys})
    model.load_state_dict(weights.crnn_state_dict(variables))
    return model.eval()


@pytest.mark.parametrize("source", ["golden", "jax_init"])
@pytest.mark.parametrize("shape", [(2, 64, 96), (1, 72, 104)])
def test_craft_slim_matches_flax(source, shape):
    """(1, 72, 104) exercises the decoder's non-2x resize path."""
    detector = JaxDetector(weights=None, width=0.25, max_components=32)
    if source == "golden":
        variables = restore_npz(os.path.join(GOLDEN, "detector_slim.npz"))
    else:
        variables = _numpy_tree(detector.variables)
    model = CRAFT(width=0.25).eval()
    model.load_state_dict(weights.craft_state_dict(variables))
    x = np.random.RandomState(0).randn(*shape, 3).astype(np.float32)
    ref = np.asarray(detector.model.apply(variables, jnp.asarray(x), train=False))
    with torch.no_grad():
        out = model(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == (shape[0], shape[1] // 2, shape[2] // 2, 2)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize("shape", [(2, 64, 96), (1, 72, 104)])
def test_craft_folded_bn_matches_flax(shape):
    """``fold_bn=True``: the JAX package's BN-folded variables run through
    the port's BN-free graph (its conv chains; on the CPU their plain
    versions). (1, 72, 104) floors an odd 9x13 map at the slice4_30 pool."""
    from keras_ocr_tpu.models.craft import fold_bn_variables

    detector = JaxDetector(weights=None, width=0.25, max_components=32, fold_bn=True)
    variables = _numpy_tree(
        fold_bn_variables(restore_npz(os.path.join(GOLDEN, "detector_slim.npz")))
    )
    model = CRAFT(width=0.25, fold_bn=True).eval()
    model.load_state_dict(weights.craft_state_dict(variables))
    x = np.random.RandomState(2).randn(*shape, 3).astype(np.float32)
    ref = np.asarray(detector.model.apply(variables, jnp.asarray(x), train=False))
    with torch.no_grad():
        out = model(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == (shape[0], shape[1] // 2, shape[2] // 2, 2)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)


def test_fold_bn_state_dict_matches_flax():
    """The port's fold of a standard state_dict equals the JAX package's
    ``fold_bn_variables`` of the same tree."""
    from keras_ocr_tpu.models.craft import fold_bn_variables

    tree = restore_npz(os.path.join(GOLDEN, "detector_slim.npz"))
    folded = fold_bn_state_dict(weights.craft_state_dict(tree))
    ref = weights.craft_state_dict(_numpy_tree(fold_bn_variables(tree)))
    assert set(folded) == set(ref) == set(CRAFT(width=0.25, fold_bn=True).state_dict())
    for key in ref:
        np.testing.assert_allclose(folded[key].numpy(), ref[key].numpy(), rtol=0, atol=1e-6)


def test_folded_detector_loads_standard_and_folded_trees():
    """``Detector(fold_bn=True).load_variables`` folds a standard tree on
    load, as the JAX ``Detector`` does, and loads a folded tree as is."""
    from keras_ocr_tpu.models.craft import fold_bn_variables

    standard = read_npz(os.path.join(GOLDEN, "detector_slim.npz"))
    folded_tree = _numpy_tree(fold_bn_variables(restore_npz(os.path.join(GOLDEN, "detector_slim.npz"))))
    a = Detector(width=0.25, fold_bn=True, device="cpu").load_variables(standard)
    b = Detector(width=0.25, fold_bn=True, device="cpu").load_variables(folded_tree)
    state_a, state_b = a.model.state_dict(), b.model.state_dict()
    assert set(state_a) == set(state_b)
    for key in state_a:
        np.testing.assert_allclose(state_a[key].numpy(), state_b[key].numpy(), rtol=0, atol=1e-6)


def _perturb_stn(variables, seed):
    """Move the STN off its identity init so the sampler is exercised."""
    rng = np.random.RandomState(seed)
    stn = variables["params"]["stn"]["dense2"]
    stn["kernel"] = (rng.randn(*stn["kernel"].shape) * 0.02).astype(np.float32)
    stn["bias"] = np.array([0.9, 0.08, 0.05, -0.06, 1.1, 0.03], np.float32)
    return variables


@pytest.mark.parametrize("shape", ["golden_slim", "production"])
def test_crnn_softmax_matches_flax(shape):
    if shape == "golden_slim":
        build_params = dict(META["recognizer_build_params"])
        recognizer = JaxRecognizer(
            weights=None, alphabet=META["alphabet"], build_params=build_params
        )
        variables = restore_npz(os.path.join(GOLDEN, "recognizer_slim.npz"))
    else:
        recognizer = JaxRecognizer(weights=None, alphabet=META["alphabet"])
        build_params = recognizer.build_params
        assert build_params["stn"] and build_params["filters"][-1] == 512
        variables = _perturb_stn(_numpy_tree(recognizer.variables), seed=0)
    model = _crnn_from(build_params, variables)
    crops = np.random.RandomState(1).rand(4, 31, 200, 1).astype(np.float32)
    ref = np.asarray(recognizer.model.apply(variables, jnp.asarray(crops), train=False))
    with torch.no_grad():
        out = model(torch.from_numpy(crops)).numpy()
    assert out.shape == ref.shape == (4, 48, 37)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


def test_seeded_init_is_reproducible_and_stn_starts_at_identity():
    a = init_parameters(CRNN(), seed=3).state_dict()
    b = init_parameters(CRNN(), seed=3).state_dict()
    c = init_parameters(CRNN(), seed=4).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["conv_1.weight"], c["conv_1.weight"])
    assert torch.equal(a["stn.dense2.weight"], torch.zeros(6, 64))
    assert a["stn.dense2.bias"].tolist() == [1.0, 0.0, 0.0, 0.0, 1.0, 0.0]
    # Orthogonal recurrent kernels, as Keras initialises them.
    hh = a["lstm_10.weight_hh_l0"]
    np.testing.assert_allclose((hh.T @ hh).numpy()[:4, :4], np.eye(4), atol=1e-5)


def test_craft_bridge_covers_every_parameter():
    state = weights.craft_state_dict(restore_npz(os.path.join(GOLDEN, "detector_slim.npz")))
    assert set(state) == set(CRAFT(width=0.25).state_dict())
    assert len(weights.craft_name_map()) == 12 * 2 + 2 + 4 * 4 + 5
