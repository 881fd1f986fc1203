"""Weight bridge between JAX-package variable trees and the port's
``state_dict``s, both ways.

A variable tree is the nested ``{"params": ..., "batch_stats": ...}`` dict
of numpy arrays the JAX package produces (``Detector.variables``,
``Recognizer.variables``, ``train/checkpoint.py:restore_npz``). Layout
changes: conv kernels HWIO -> OIHW, Dense ``(in, out)`` -> Linear
``(out, in)``, Keras LSTM ``kernel (in, 4u)`` / ``recurrent_kernel (u, 4u)``
/ ``bias (4u,)`` -> ``weight_ih (4u, in)`` / ``weight_hh (4u, u)`` /
``bias_ih`` with a zero ``bias_hh`` (the gate order [i, f, c~, o] is
PyTorch's [i, f, g, o]). The way back (``craft_variables``,
``crnn_variables``) inverts each change and returns the LSTM bias as
``bias_ih + bias_hh``; a tree that goes there and back is unchanged.
"""

from __future__ import annotations

import typing

import numpy as np
import torch

from .models.craft import VGG_BLOCKS


def read_npz(path: str) -> dict:
    """Read a flat ``a/b/c``-keyed ``.npz`` (``train/checkpoint.py:save_npz``)
    into a nested dict, upcasting floats to float32."""
    tree: dict = {}
    with np.load(path) as data:
        for key in data.files:
            value = data[key]
            if np.issubdtype(value.dtype, np.floating):
                value = value.astype(np.float32)
            node = tree
            parts = key.split("/")
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = value
    return tree


def craft_name_map() -> typing.Dict[str, typing.Tuple[str, str]]:
    """Reference CRAFT layer names -> (module path in the port, kind).

    The reference names mirror the clovaai torch ``state_dict``; the port's
    module paths mirror the Flax tree (``basenet.slice1_0.conv``, ...).
    """
    mapping: typing.Dict[str, typing.Tuple[str, str]] = {}
    for slice_name, idx, _, _ in VGG_BLOCKS:
        base = f"basenet.{slice_name}_{idx}"
        mapping[f"basenet.{slice_name}.{idx}"] = (f"{base}.conv", "conv")
        mapping[f"basenet.{slice_name}.{idx + 1}"] = (f"{base}.bn", "bn")
    mapping["basenet.slice5.1"] = ("slice5_1", "conv")
    mapping["basenet.slice5.2"] = ("slice5_2", "conv")
    for i in range(1, 5):
        mapping[f"upconv{i}.conv.0"] = (f"upconv{i}.block0.conv", "conv")
        mapping[f"upconv{i}.conv.1"] = (f"upconv{i}.block0.bn", "bn")
        mapping[f"upconv{i}.conv.3"] = (f"upconv{i}.block1.conv", "conv")
        mapping[f"upconv{i}.conv.4"] = (f"upconv{i}.block1.bn", "bn")
    for n in (0, 2, 4, 6, 8):
        mapping[f"conv_cls.{n}"] = (f"conv_cls_{n}", "conv")
    return mapping


def _node(tree: dict, path: str):
    for key in path.split("."):
        if key not in tree:
            return None
        tree = tree[key]
    return tree


def _tensor(array) -> torch.Tensor:
    return torch.from_numpy(np.array(array, dtype=np.float32))


def _conv(state, path, leaf):
    state[f"{path}.weight"] = _tensor(np.transpose(leaf["kernel"], (3, 2, 0, 1)))
    state[f"{path}.bias"] = _tensor(leaf["bias"])


def _dense(state, path, leaf):
    state[f"{path}.weight"] = _tensor(np.transpose(leaf["kernel"]))
    state[f"{path}.bias"] = _tensor(leaf["bias"])


def _bn(state, path, leaf, stats):
    state[f"{path}.weight"] = _tensor(leaf["scale"])
    state[f"{path}.bias"] = _tensor(leaf["bias"])
    state[f"{path}.running_mean"] = _tensor(stats["mean"])
    state[f"{path}.running_var"] = _tensor(stats["var"])
    state[f"{path}.num_batches_tracked"] = torch.tensor(0)


def craft_state_dict(variables: dict) -> dict:
    """CRAFT variable tree (standard or BN-folded) -> ``CRAFT`` state_dict."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    state: dict = {}
    for path, kind in craft_name_map().values():
        leaf = _node(params, path)
        if leaf is None and kind == "bn":
            continue  # a BN-folded tree has no BatchNorm leaves
        if kind == "conv":
            _conv(state, path, leaf)
        else:
            _bn(state, path, leaf, _node(stats, path))
    return state


def crnn_state_dict(variables: dict) -> dict:
    """CRNN variable tree -> ``CRNN`` state_dict."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    state: dict = {}
    for i in range(1, 8):
        _conv(state, f"conv_{i}", params[f"conv_{i}"])
    for name in ("bn_3", "bn_5", "bn_7"):
        _bn(state, name, params[name], stats[name])
    for name in ("fc_9", "fc_12"):
        _dense(state, name, params[name])
    for layer in ("lstm_10", "lstm_11"):
        for suffix, source in (("", layer), ("_reverse", f"{layer}_back")):
            leaf = params[source]
            state[f"{layer}.weight_ih_l0{suffix}"] = _tensor(np.transpose(leaf["kernel"]))
            state[f"{layer}.weight_hh_l0{suffix}"] = _tensor(
                np.transpose(leaf["recurrent_kernel"])
            )
            state[f"{layer}.bias_ih_l0{suffix}"] = _tensor(leaf["bias"])
            state[f"{layer}.bias_hh_l0{suffix}"] = torch.zeros(leaf["bias"].shape[0])
    if "stn" in params:
        stn = params["stn"]
        _conv(state, "stn.conv1", stn["conv1"])
        _conv(state, "stn.conv2", stn["conv2"])
        _dense(state, "stn.dense1", stn["dense1"])
        _dense(state, "stn.dense2", stn["dense2"])
    return state


def _state(source) -> typing.Mapping[str, torch.Tensor]:
    return source.state_dict() if isinstance(source, torch.nn.Module) else source


def _array(tensor) -> np.ndarray:
    """A float32 numpy copy (never a view of the tensor's storage)."""
    return tensor.detach().to("cpu", torch.float32).numpy().copy()


def _put(tree: dict, path: str, leaf: dict):
    *parents, last = path.split(".")
    for key in parents:
        tree = tree.setdefault(key, {})
    tree[last] = leaf


def _conv_leaf(state, path):
    return {"kernel": np.transpose(_array(state[f"{path}.weight"]), (2, 3, 1, 0)),
            "bias": _array(state[f"{path}.bias"])}


def _dense_leaf(state, path):
    return {"kernel": np.transpose(_array(state[f"{path}.weight"])),
            "bias": _array(state[f"{path}.bias"])}


def _put_bn(params, stats, state, path):
    _put(params, path, {"scale": _array(state[f"{path}.weight"]),
                        "bias": _array(state[f"{path}.bias"])})
    _put(stats, path, {"mean": _array(state[f"{path}.running_mean"]),
                       "var": _array(state[f"{path}.running_var"])})


def _tree(params: dict, stats: dict) -> dict:
    return {"params": params, "batch_stats": stats} if stats else {"params": params}


def craft_variables(source) -> dict:
    """``CRAFT`` module or state_dict -> JAX-package variable tree (numpy
    copies); a BN-folded model gives a tree without ``batch_stats``."""
    state = _state(source)
    params: dict = {}
    stats: dict = {}
    for path, kind in craft_name_map().values():
        if kind == "conv":
            _put(params, path, _conv_leaf(state, path))
        elif f"{path}.weight" in state:
            _put_bn(params, stats, state, path)
    return _tree(params, stats)


def crnn_variables(source) -> dict:
    """``CRNN`` module or state_dict -> JAX-package variable tree (numpy
    copies)."""
    state = _state(source)
    params: dict = {}
    stats: dict = {}
    for i in range(1, 8):
        params[f"conv_{i}"] = _conv_leaf(state, f"conv_{i}")
    for name in ("bn_3", "bn_5", "bn_7"):
        _put_bn(params, stats, state, name)
    for name in ("fc_9", "fc_12"):
        params[name] = _dense_leaf(state, name)
    for layer in ("lstm_10", "lstm_11"):
        for suffix, target in (("", layer), ("_reverse", f"{layer}_back")):
            bias = _array(state[f"{layer}.bias_ih_l0{suffix}"]) + _array(
                state[f"{layer}.bias_hh_l0{suffix}"])
            params[target] = {
                "kernel": np.transpose(_array(state[f"{layer}.weight_ih_l0{suffix}"])),
                "recurrent_kernel": np.transpose(_array(state[f"{layer}.weight_hh_l0{suffix}"])),
                "bias": bias,
            }
    if "stn.conv1.weight" in state:
        params["stn"] = {
            "conv1": _conv_leaf(state, "stn.conv1"), "conv2": _conv_leaf(state, "stn.conv2"),
            "dense1": _dense_leaf(state, "stn.dense1"), "dense2": _dense_leaf(state, "stn.dense2"),
        }
    return _tree(params, stats)
