"""Variable trees -> the published weight formats.

A model trained with the port can be written as a Keras ``.h5`` that
keras-ocr's ``build_keras_model(weights_path=...)`` / ``Recognizer`` load
(Keras's topological ``load_weights``), or as a CRAFT ``.pth`` in clovaai's
names. The ``.h5`` files are what Keras 2's ``save_weights`` writes: a
group per layer (weightless layers with an empty ``weight_names``), the
``layer_names`` / ``backend`` / ``keras_version`` root attributes as
fixed-length byte strings, and the reference graphs' topological layer
order. Auto-generated names such as ``upsample_like_1`` are labels only:
Keras's topological loader matches by order. They go through the port's
HDF5 writer (:mod:`..h5`).
"""

from __future__ import annotations

import typing

import numpy as np
import torch

from .. import h5
from . import (
    CRNN_BN_LAYERS,
    CRNN_CONV_LAYERS,
    CRNN_DENSE_LAYERS,
    CRNN_LSTM_LAYERS,
    CRNN_STN_LAYERS,
    _node,
    craft_name_map,
)

# The reference CRAFT graph's topological layer order: the VGG16-BN
# slices, the dilated slice5, four upconv blocks with bilinear upsampling
# and skip concatenations, and the head.
_CRAFT_VGG_SLICES = (
    ("slice1", range(0, 14)),
    ("slice2", range(14, 20)),
    ("slice3", range(20, 30)),
    ("slice4", range(30, 39)),
)


def _craft_layer_order() -> typing.List[str]:
    order = ["input_1"]
    for slice_name, indices in _CRAFT_VGG_SLICES:
        order.extend(f"basenet.{slice_name}.{i}" for i in indices)
    order.extend(["basenet.slice5.0", "basenet.slice5.1", "basenet.slice5.2"])
    order.append("concatenate")
    for i in range(1, 5):
        order.extend(f"upconv{i}.conv.{j}" for j in range(6))
        if i < 4:
            order.append("upsample_like" if i == 1 else f"upsample_like_{i - 1}")
            order.append(f"concatenate_{i}")
    order.extend(f"conv_cls.{i}" for i in range(9))
    return order


# The reference CRNN graphs' topological layer order with the default build
# parameters; "model_2" is the auto-named nested STN localization model.
_CRNN_BACKBONE_ORDER = [
    "input_2", "permute", "lambda", "conv_1", "conv_2", "conv_3", "bn_3", "maxpool_3",
    "conv_4", "conv_5", "bn_5", "maxpool_5", "conv_6", "conv_7", "bn_7", "model_2",
    "lambda_1", "reshape", "fc_9", "lstm_10", "lstm_10_back", "add", "lstm_11",
    "lstm_11_back", "concatenate_4",
]
_CRNN_TOP_ORDER = _CRNN_BACKBONE_ORDER + ["dropout", "fc_12", "lambda_2"]

# The nested STN model's inner layers in build order, with the auto-names
# Keras gives them in a fresh process.
_STN_INNER_NAMES = ("conv2d", "conv2d_1", "dense", "dense_1")


def _write_h5(path: str, layer_order: typing.List[str], weights: dict) -> None:
    """Write a Keras-2 ``save_weights`` file. ``weights`` maps a layer name
    to its ordered ``(weight_name, array)`` list; layers absent from it are
    written as weightless groups."""
    with h5.File(path, "w") as f:
        f.attrs["layer_names"] = np.array([name.encode("utf8") for name in layer_order])
        f.attrs["backend"] = np.bytes_(b"tensorflow")
        f.attrs["keras_version"] = np.bytes_(b"2.15.0")
        for layer_name in layer_order:
            group = f.create_group(layer_name)
            entries = weights.get(layer_name, [])
            group.attrs["weight_names"] = np.array([name.encode("utf8") for name, _ in entries])
            for name, array in entries:
                group.create_dataset(name, data=np.asarray(array, dtype=np.float32))


def _conv_entries(name, leaf):
    return [(f"{name}/kernel:0", leaf["kernel"]), (f"{name}/bias:0", leaf["bias"])]


def _bn_entries(name, leaf, stats):
    return [(f"{name}/gamma:0", leaf["scale"]), (f"{name}/beta:0", leaf["bias"]),
            (f"{name}/moving_mean:0", stats["mean"]),
            (f"{name}/moving_variance:0", stats["var"])]


def craft_variables_to_h5(variables: dict, path: str) -> str:
    """Write a standard CRAFT variable tree as a Keras ``.h5`` that
    :func:`..craft_variables_from_h5` and keras-ocr's
    ``build_keras_model(weights_path=...)`` read back."""
    weights: dict = {}
    for ref_name, (tree_path, kind) in craft_name_map().items():
        leaf = _node(variables["params"], tree_path)
        if kind == "conv":
            weights[ref_name] = _conv_entries(ref_name, leaf)
        else:
            weights[ref_name] = _bn_entries(ref_name, leaf,
                                            _node(variables["batch_stats"], tree_path))
    _write_h5(path, _craft_layer_order(), weights)
    return path


def crnn_variables_to_h5(variables: dict, path: str, include_top: bool = True) -> str:
    """Write a CRNN variable tree of the default build parameters as a
    Keras ``.h5``: keras-ocr's ``model.load_weights`` (top) or
    ``backbone.load_weights`` (notop, without ``fc_12``) restores it. A
    tree without ``params["stn"]`` gives the ``stn=False`` graph's file,
    without the localization model and its transform layer."""
    params = variables["params"]
    stats = variables["batch_stats"]
    weights: dict = {}
    for name in CRNN_CONV_LAYERS:
        weights[name] = _conv_entries(name, params[name])
    for name in CRNN_BN_LAYERS:
        weights[name] = _bn_entries(name, params[name], stats[name])
    for name in CRNN_LSTM_LAYERS:
        leaf = params[name]
        weights[name] = [
            (f"{name}/lstm_cell/kernel:0", leaf["kernel"]),
            (f"{name}/lstm_cell/recurrent_kernel:0", leaf["recurrent_kernel"]),
            (f"{name}/lstm_cell/bias:0", leaf["bias"]),
        ]
    for name in CRNN_DENSE_LAYERS if include_top else CRNN_DENSE_LAYERS[:1]:
        weights[name] = _conv_entries(name, params[name])
    order = _CRNN_TOP_ORDER if include_top else _CRNN_BACKBONE_ORDER
    if "stn" in params:
        weights["model_2"] = [
            entry
            for ours, inner in zip(CRNN_STN_LAYERS, _STN_INNER_NAMES)
            for entry in _conv_entries(inner, params["stn"][ours])
        ]
    else:
        order = [n for n in order if n not in ("model_2", "lambda_1")]
    _write_h5(path, order, weights)
    return path


def craft_variables_to_torch_state_dict(variables: dict) -> dict:
    """A standard CRAFT variable tree -> a clovaai-named numpy
    ``state_dict``: conv kernels HWIO -> OIHW, BatchNorm as weight / bias /
    running_mean / running_var with torch's ``num_batches_tracked``."""
    state: dict = {}
    for ref_name, (tree_path, kind) in craft_name_map().items():
        leaf = _node(variables["params"], tree_path)
        if kind == "conv":
            state[f"{ref_name}.weight"] = np.asarray(
                leaf["kernel"], dtype=np.float32).transpose(3, 2, 0, 1)
            state[f"{ref_name}.bias"] = np.asarray(leaf["bias"], dtype=np.float32)
        else:
            stats = _node(variables["batch_stats"], tree_path)
            state[f"{ref_name}.weight"] = np.asarray(leaf["scale"], dtype=np.float32)
            state[f"{ref_name}.bias"] = np.asarray(leaf["bias"], dtype=np.float32)
            state[f"{ref_name}.running_mean"] = np.asarray(stats["mean"], dtype=np.float32)
            state[f"{ref_name}.running_var"] = np.asarray(stats["var"], dtype=np.float32)
            state[f"{ref_name}.num_batches_tracked"] = np.asarray(0, dtype=np.int64)
    return state


def save_craft_torch_checkpoint(variables: dict, path: str) -> str:
    """Write a standard CRAFT variable tree as a clovaai-named ``.pth``
    that :func:`..load_torch_checkpoint` and keras-ocr's torch CRAFT load."""
    state = {
        key: torch.from_numpy(np.ascontiguousarray(value).copy())
        for key, value in craft_variables_to_torch_state_dict(variables).items()
    }
    torch.save(state, path)
    return path
