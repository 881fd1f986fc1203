"""Checkpoints of variable trees as ``.npz`` files.

Port of ``keras_ocr_tpu/train/checkpoint.py`` without orbax: a tree is
flattened to ``a/b/c`` keys, the JAX package's layout, so each package
reads the other's ``.npz`` checkpoints. An orbax directory written by the
JAX package is not readable here.
"""

from __future__ import annotations

import os
import typing

import numpy as np


def _flatten(tree, prefix=""):
    out = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(value, dict):
            out.update(_flatten(value, path))
        else:
            out[path] = np.asarray(value)
    return out


def _unflatten(flat):
    tree: dict = {}
    for path, value in flat.items():
        keys = path.split("/")
        node = tree
        for key in keys[:-1]:
            node = node.setdefault(key, {})
        node[keys[-1]] = value
    return tree


def _cast(flat, cast):
    if cast is None:
        return flat
    return {
        key: value.astype(cast) if np.issubdtype(value.dtype, np.floating) else value
        for key, value in flat.items()
    }


def save(path: str, variables) -> str:
    """Save a variable tree as ``path`` + ``.npz`` (uncompressed, the JAX
    package's fallback format); returns the file's path."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **_flatten(variables))
    return path


def save_npz(path: str, variables, cast: typing.Optional[type] = None) -> str:
    """Save a variable tree as one compressed ``.npz`` file; ``cast`` (say
    ``np.float16``) casts the float leaves."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(path, **_cast(_flatten(variables), cast))
    return path


def restore_npz(path: str, cast: typing.Optional[type] = np.float32) -> dict:
    """Restore a tree saved by :func:`save_npz`, casting float leaves to
    ``cast``."""
    with np.load(path) as data:
        flat = {key: data[key] for key in data.files}
    return _unflatten(_cast(flat, cast))


def restore(path: str) -> dict:
    """Restore a variable tree saved by :func:`save` (``path`` with or
    without its ``.npz``)."""
    if not path.endswith(".npz") and os.path.isfile(path + ".npz"):
        path = path + ".npz"
    if not os.path.isfile(path):
        raise FileNotFoundError(
            f"{path}: no .npz checkpoint (orbax directories are not readable here)")
    with np.load(path) as data:
        return _unflatten({k: data[k] for k in data.files})


def latest(directory: str, prefix: str = "") -> typing.Optional[str]:
    """Most recently modified checkpoint path under a directory, or None."""
    if not os.path.isdir(directory):
        return None
    candidates = [
        os.path.join(directory, name)
        for name in os.listdir(directory)
        if name.startswith(prefix)
    ]
    if not candidates:
        return None
    return max(candidates, key=os.path.getmtime)
