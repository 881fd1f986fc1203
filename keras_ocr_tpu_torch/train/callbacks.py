"""Keras-style training callbacks: early stopping, checkpointing, CSV log.

Port of ``keras_ocr_tpu/train/callbacks.py``, with the same stop and CSV
semantics. A callback reads and writes its trainer's ``variables``, a numpy
tree that shares no storage with the live model. On a mesh across
processes every process runs the callbacks on the same logs; the files are
written by rank 0 (:func:`.checkpoint.write_once`).
"""

from __future__ import annotations

import csv
import os
import typing


class Callback:
    def on_epoch_end(self, epoch: int, logs: dict, owner) -> bool:
        """Return True to stop training."""
        return False


class EarlyStopping(Callback):
    """Stop once ``monitor`` has not improved for ``patience`` epochs; with
    ``restore_best_weights`` the owner then takes back the best epoch's
    variables."""

    def __init__(self, monitor: str = "loss", patience: int = 5,
                 restore_best_weights: bool = False):
        self.monitor = monitor
        self.patience = patience
        self.restore_best_weights = restore_best_weights
        self.best: typing.Optional[float] = None
        self.best_variables = None
        self.wait = 0

    def on_epoch_end(self, epoch, logs, owner):
        value = logs[self.monitor]
        if self.best is None or value < self.best:
            self.best = value
            self.wait = 0
            if self.restore_best_weights:
                self.best_variables = owner.variables
            return False
        self.wait += 1
        if self.wait >= self.patience:
            if self.restore_best_weights and self.best_variables is not None:
                owner.variables = self.best_variables
            return True
        return False


class ModelCheckpoint(Callback):
    """Save the owner's variables (:func:`.checkpoint.save`) each epoch, or
    only on a new best of ``monitor``."""

    def __init__(self, filepath: str, monitor: str = "loss", save_best_only: bool = True):
        self.filepath = filepath
        self.monitor = monitor
        self.save_best_only = save_best_only
        self.best: typing.Optional[float] = None

    def on_epoch_end(self, epoch, logs, owner):
        from . import checkpoint

        value = logs[self.monitor]
        if not self.save_best_only or self.best is None or value < self.best:
            self.best = value
            checkpoint.save(self.filepath, owner.variables)
        return False


class CSVLogger(Callback):
    """Append one row per epoch (``epoch`` then the logs, sorted by key),
    with a header when the file is new."""

    def __init__(self, filename: str):
        self.filename = filename
        self._initialized = False

    def on_epoch_end(self, epoch, logs, owner):
        from .checkpoint import write_once

        write_header = not self._initialized and not os.path.exists(self.filename)

        def write():
            with open(self.filename, "a", newline="") as f:
                writer = csv.writer(f)
                if write_header:
                    writer.writerow(["epoch"] + sorted(logs))
                writer.writerow([epoch] + [logs[k] for k in sorted(logs)])

        write_once(write)
        self._initialized = True
        return False


class CallbackList:
    def __init__(self, callbacks: typing.List[Callback], owner):
        self.callbacks = callbacks
        self.owner = owner

    def on_epoch_end(self, epoch: int, logs: dict) -> bool:
        stop = False
        for callback in self.callbacks:
            stop = callback.on_epoch_end(epoch, logs, self.owner) or stop
        return stop
