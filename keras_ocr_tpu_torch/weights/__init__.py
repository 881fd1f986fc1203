"""Weights of the port: the published-weight registry and its offline
lookup, the ``.pth`` and Keras ``.h5`` loaders, and the bridge between
JAX-package variable trees and the port's ``state_dict``s.

The registry (``DETECTOR_PRETRAINED``, ``RECOGNIZER_PRETRAINED``) names
keras-ocr's release files with their sha256. :func:`download_pretrained`
resolves an entry to a verified local file: the vendored directory
(``<repo>/weights_pretrained``), then the cache, then the network.
:func:`load_craft_weights` reads a CRAFT ``.h5`` (Keras) or ``.pth``
(clovaai ``state_dict``) and :func:`crnn_variables_from_h5` a CRNN ``.h5``
into a variable tree; the ``.h5`` files go through the port's own HDF5
reader (:mod:`..h5`). The writers are in :mod:`.export`, the independent
torch forward over clovaai names in :mod:`.torch_twin`.

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

import os
import shutil
import typing

import numpy as np
import torch

from .. import h5, tools
from ..models.craft import VGG_BLOCKS

DETECTOR_PRETRAINED = {
    ("clovaai_general", True): {
        "url": "https://github.com/faustomorales/keras-ocr/releases/download/v0.8.4/craft_mlt_25k.pth",
        "filename": "craft_mlt_25k.pth",
        "sha256": "4a5efbfb48b4081100544e75e1e2b57f8de3d84f213004b14b85fd4b3748db17",
    },
    ("clovaai_general", False): {
        "url": "https://github.com/faustomorales/keras-ocr/releases/download/v0.8.4/craft_mlt_25k.h5",
        "filename": "craft_mlt_25k.h5",
        "sha256": "7283ce2ff05a0617e9740c316175ff3bacdd7215dbdf1a726890d5099431f899",
    },
}

RECOGNIZER_PRETRAINED: typing.Dict[str, typing.Any] = {
    "kurapan": {
        "weights": {
            "notop": {
                "url": "https://github.com/faustomorales/keras-ocr/releases/download/v0.8.4/crnn_kurapan_notop.h5",
                "filename": "crnn_kurapan_notop.h5",
                "sha256": "027fd2cced3cbea0c4f5894bb8e9e85bac04f11daf96b8fdcf1e4ee95dcf51b9",
            },
            "top": {
                "url": "https://github.com/faustomorales/keras-ocr/releases/download/v0.8.4/crnn_kurapan.h5",
                "filename": "crnn_kurapan.h5",
                "sha256": "a7d8086ac8f5c3d6a0a828f7d6fbabcaf815415dd125c32533013f85603be46d",
            },
        },
    }
}

# Public mirrors of the keras-ocr release files, tried after the
# canonical URL (``{filename}`` is filled in).
WEIGHT_MIRRORS: typing.Tuple[str, ...] = (
    "https://huggingface.co/spuun/keras-ocr-weights/resolve/main/{filename}",
    "https://storage.googleapis.com/keras-ocr/{filename}",
)


def vendored_weights_dir() -> str:
    """The directory searched for weight files before the cache and the
    network: ``KERAS_OCR_TPU_VENDORED_WEIGHTS``, else
    ``<repo>/weights_pretrained``."""
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    return os.environ.get("KERAS_OCR_TPU_VENDORED_WEIGHTS",
                          os.path.join(repo, "weights_pretrained"))


def vendor_weight_file(path: str) -> str:
    """Copy a verified weight file into the vendored directory (unless an
    identical copy is there); returns the vendored path."""
    dest_dir = vendored_weights_dir()
    os.makedirs(dest_dir, exist_ok=True)
    dest = os.path.join(dest_dir, os.path.basename(path))
    if os.path.abspath(dest) != os.path.abspath(path) and (
        not os.path.isfile(dest) or tools.sha256sum(dest) != tools.sha256sum(path)
    ):
        shutil.copyfile(path, dest)
    return dest


def download_pretrained(config: dict) -> str:
    """Resolve a registry entry to a local file whose hash matches.

    Order: the vendored copy, then the cache (inside
    :func:`..tools.download_and_verify`), then the
    ``KERAS_OCR_TPU_WEIGHTS_MIRROR`` base, the canonical URL and the
    public mirrors. An entry carries ``sha256``, or ``md5`` where its
    upstream publishes only that; a cached md5 file that does not match
    is downloaded once more from the same URL. Raises ``RuntimeError``
    naming the file when no source gives it.
    """
    filename = config["filename"]
    if "sha256" in config:
        expected, hash_fn = config["sha256"], tools.sha256sum
    else:
        expected, hash_fn = config["md5"], tools.md5sum
    vendored = os.path.join(vendored_weights_dir(), filename)
    if os.path.isfile(vendored) and hash_fn(vendored) == expected:
        return vendored
    urls = [config["url"]]
    mirror_base = os.environ.get("KERAS_OCR_TPU_WEIGHTS_MIRROR")
    if mirror_base:
        urls.insert(0, mirror_base.rstrip("/") + "/" + filename)
    urls.extend(m.format(filename=filename) for m in WEIGHT_MIRRORS)
    last_exc: typing.Optional[Exception] = None
    for url in urls:
        try:
            if hash_fn is tools.sha256sum:
                return tools.download_and_verify(url=url, filename=filename, sha256=expected)
            path = tools.download_and_verify(url=url, filename=filename)
            if tools.md5sum(path) != expected:
                # With no sha256 a cached file is trusted as it is: evict
                # it and download from the same URL once more.
                os.remove(path)
                path = tools.download_and_verify(url=url, filename=filename)
                if tools.md5sum(path) != expected:
                    os.remove(path)
                    raise ValueError(f"md5 mismatch for {path} (from {url})")
            return path
        except Exception as exc:  # noqa: BLE001 - any failure moves on to the next source
            last_exc = exc
    raise RuntimeError(
        f"Could not obtain {filename} from any of {len(urls)} sources "
        f"(vendored dir {vendored_weights_dir()!r} missing it too): {last_exc}"
    ) from last_exc


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


# ---------------------------------------------------------------------------
# Published files -> variable trees
# ---------------------------------------------------------------------------


def craft_variables_from_torch_state_dict(state_dict) -> dict:
    """A clovaai-named CRAFT ``state_dict`` (``module.`` prefixes allowed,
    ``num_batches_tracked`` ignored) -> a float32 variable tree: conv
    kernels OIHW -> HWIO, BatchNorm weight / bias / running statistics ->
    scale / bias params and mean / var statistics."""
    cleaned = {
        (key[len("module."):] if key.startswith("module.") else key): np.asarray(value)
        for key, value in state_dict.items()
    }
    params: dict = {}
    stats: dict = {}
    for ref_name, (path, kind) in craft_name_map().items():
        if kind == "conv":
            _put(params, path, {
                "kernel": cleaned[f"{ref_name}.weight"].transpose(2, 3, 1, 0).astype(np.float32),
                "bias": cleaned[f"{ref_name}.bias"].astype(np.float32),
            })
        else:
            _put(params, path, {"scale": cleaned[f"{ref_name}.weight"].astype(np.float32),
                                "bias": cleaned[f"{ref_name}.bias"].astype(np.float32)})
            _put(stats, path, {"mean": cleaned[f"{ref_name}.running_mean"].astype(np.float32),
                               "var": cleaned[f"{ref_name}.running_var"].astype(np.float32)})
    return {"params": params, "batch_stats": stats}


def load_torch_checkpoint(path: str) -> dict:
    """A CRAFT ``.pth`` (zip or legacy format) -> a variable tree. Loaded
    with ``weights_only=True``: tensors and containers only."""
    state_dict = torch.load(path, map_location="cpu", weights_only=True)
    return craft_variables_from_torch_state_dict(
        {key: value.numpy() for key, value in state_dict.items()})


def _h5_layer_weights(h5file, layer_name: str) -> typing.List[np.ndarray]:
    """The weight arrays of one Keras layer, in its ``weight_names`` order
    (every dataset below the layer's group, if it has none)."""
    root = h5file["model_weights"] if "model_weights" in h5file else h5file
    if layer_name not in root:
        raise KeyError(layer_name)
    group = root[layer_name]
    names = group.attrs.get("weight_names")
    arrays = []
    if names is not None:
        for name in names:
            if isinstance(name, bytes):
                name = name.decode()
            arrays.append(np.asarray(group[name]))
    else:
        def visit(_, node):
            if isinstance(node, h5.Dataset):
                arrays.append(np.asarray(node))

        group.visititems(visit)
    return arrays


def craft_variables_from_h5(path: str) -> dict:
    """The published ``craft_mlt_25k.h5`` (or any Keras file of the CRAFT
    graph) -> a variable tree. Keras stores conv as [kernel (HWIO), bias]
    and BatchNorm as [gamma, beta, moving_mean, moving_variance]: the
    tree's own layout, so only the names change."""
    params: dict = {}
    stats: dict = {}
    with h5.File(path) as f:
        for ref_name, (tree_path, kind) in craft_name_map().items():
            arrays = _h5_layer_weights(f, ref_name)
            if kind == "conv":
                kernel, bias = arrays
                _put(params, tree_path, {"kernel": kernel.astype(np.float32),
                                         "bias": bias.astype(np.float32)})
            else:
                gamma, beta, mean, var = arrays
                _put(params, tree_path, {"scale": gamma.astype(np.float32),
                                         "bias": beta.astype(np.float32)})
                _put(stats, tree_path, {"mean": mean.astype(np.float32),
                                        "var": var.astype(np.float32)})
    return {"params": params, "batch_stats": stats}


def load_craft_weights(path: str) -> dict:
    """A CRAFT weight file -> a variable tree, by extension (``.h5`` Keras,
    ``.pth`` torch)."""
    if path.endswith(".h5"):
        return craft_variables_from_h5(path)
    if path.endswith(".pth"):
        return load_torch_checkpoint(path)
    raise NotImplementedError(f"Cannot load weights from {path}")


def _leaf_shapes(tree: dict, prefix: str = "") -> typing.Dict[str, tuple]:
    shapes = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(value, dict):
            shapes.update(_leaf_shapes(value, path))
        else:
            shapes[path] = tuple(np.shape(value))
    return shapes


def validate_against(variables: dict, reference_variables: dict) -> None:
    """Raise ``ValueError`` unless the two trees have the same leaves with
    the same shapes."""
    got, want = _leaf_shapes(variables), _leaf_shapes(reference_variables)
    for key, shape in got.items():
        if key not in want:
            raise ValueError(f"Missing {key}")
        if want[key] != shape:
            raise ValueError(f"Shape mismatch at {key}: {want[key]} vs {shape}")
    if len(got) != len(want):
        raise ValueError(f"Variable count mismatch: {len(got)} vs {len(want)}")


CRNN_CONV_LAYERS = tuple(f"conv_{i}" for i in range(1, 8))
CRNN_BN_LAYERS = ("bn_3", "bn_5", "bn_7")
CRNN_LSTM_LAYERS = ("lstm_10", "lstm_10_back", "lstm_11", "lstm_11_back")
CRNN_DENSE_LAYERS = ("fc_9", "fc_12")
# The STN's layers in the tree, in the build order of the reference's
# nested localization model: two 5x5 convs, then two dense layers.
CRNN_STN_LAYERS = ("conv1", "conv2", "dense1", "dense2")


def _h5_find_stn_group(h5file):
    """The group of the nested localization model in a CRNN ``.h5``. Keras
    auto-names it ("model", "model_2", "functional", ...), so it is found
    by its weight names: both conv2d and dense variables."""
    root = h5file["model_weights"] if "model_weights" in h5file else h5file
    for name in root:
        group = root[name]
        names = group.attrs.get("weight_names")
        if names is None:
            continue
        joined = b"|".join(n if isinstance(n, bytes) else n.encode() for n in names)
        if b"conv2d" in joined and b"dense" in joined:
            return group
    return None


def crnn_variables_from_h5(path: str, include_top: bool = True) -> dict:
    """A published CRNN ``.h5`` (top, or notop without ``fc_12``) -> a
    variable tree. Keras's layouts are the tree's: conv [kernel (HWIO),
    bias], BatchNorm [gamma, beta, mean, var], Dense [kernel (in, out),
    bias], LSTM [kernel (in, 4u), recurrent_kernel (u, 4u), bias (4u)]."""
    params: dict = {}
    stats: dict = {}
    with h5.File(path) as f:
        for name in CRNN_CONV_LAYERS:
            kernel, bias = _h5_layer_weights(f, name)
            params[name] = {"kernel": kernel.astype(np.float32), "bias": bias.astype(np.float32)}
        for name in CRNN_BN_LAYERS:
            gamma, beta, mean, var = _h5_layer_weights(f, name)
            params[name] = {"scale": gamma.astype(np.float32), "bias": beta.astype(np.float32)}
            stats[name] = {"mean": mean.astype(np.float32), "var": var.astype(np.float32)}
        for name in CRNN_LSTM_LAYERS:
            kernel, recurrent, bias = _h5_layer_weights(f, name)
            params[name] = {
                "kernel": kernel.astype(np.float32),
                "recurrent_kernel": recurrent.astype(np.float32),
                "bias": bias.astype(np.float32),
            }
        for name in CRNN_DENSE_LAYERS if include_top else CRNN_DENSE_LAYERS[:1]:
            kernel, bias = _h5_layer_weights(f, name)
            params[name] = {"kernel": kernel.astype(np.float32), "bias": bias.astype(np.float32)}
        stn = _h5_find_stn_group(f)
        if stn is not None:
            names = [n.decode() if isinstance(n, bytes) else n for n in stn.attrs["weight_names"]]
            # The inner layers carry the global Keras name counters of the
            # process that saved the file ("conv2d_9", "conv2d_10", ...),
            # which do not sort in build order; ``weight_names`` keeps that
            # order. Group by appearance, tell convs from denses by kernel
            # rank, and check the output widths.
            groups: dict = {}
            for n in names:
                groups.setdefault(n.split("/")[-2], []).append(np.asarray(stn[n]))
            convs = [v for v in groups.values() if v[0].ndim == 4]
            denses = [v for v in groups.values() if v[0].ndim == 2]
            if len(convs) != 2 or len(denses) != 2:
                raise ValueError(
                    "Unexpected STN localization-net structure in "
                    f"{path!r}: {[(k, v[0].shape) for k, v in groups.items()]}"
                )
            expected_out = {"conv1": 16, "conv2": 32, "dense1": 64, "dense2": 6}
            stn_params = {}
            for ours, (kernel, bias) in zip(CRNN_STN_LAYERS, convs + denses):
                if kernel.shape[-1] != expected_out[ours]:
                    raise ValueError(
                        f"STN layer {ours} expects {expected_out[ours]} output features, "
                        f"found kernel {kernel.shape} in {path!r}"
                    )
                stn_params[ours] = {"kernel": kernel.astype(np.float32),
                                    "bias": bias.astype(np.float32)}
            params["stn"] = stn_params
    return {"params": params, "batch_stats": stats}


# The writers (variable trees -> Keras .h5 and clovaai .pth) use the
# tables above.
from .export import (  # noqa: E402
    craft_variables_to_h5,
    craft_variables_to_torch_state_dict,
    crnn_variables_to_h5,
    save_craft_torch_checkpoint,
)
