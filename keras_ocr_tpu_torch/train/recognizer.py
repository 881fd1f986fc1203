"""CRNN recognizer training: CTC loss and RMSprop on one device.

Port of ``keras_ocr_tpu/train/recognizer.py``: one step runs the CRNN in
training mode (batch statistics, dropout) to pre-softmax frames, takes
``mean(ctc_loss * sample_weights)``, back-propagates and steps the
optimiser. The model is trained in place, so the recognizer (and a
``Pipeline`` built on it) reads with the new weights at once.
"""

from __future__ import annotations

import typing

import numpy as np
import torch

from .. import weights as weights_lib
from ..ops.ctc import ctc_loss
from .callbacks import CallbackList
from .optim import RMSprop

OptimizerFactory = typing.Callable[[typing.List[torch.nn.Parameter]], torch.optim.Optimizer]


def trainable(model: torch.nn.Module) -> typing.List[torch.nn.Parameter]:
    """The parameters an optimiser may move (the CRNN's frozen ``bias_hh``
    excluded)."""
    return [param for param in model.parameters() if param.requires_grad]


def check_single_device(mesh, tensor_parallel=False):
    if mesh is not None or tensor_parallel:
        raise NotImplementedError(
            "the port trains on one device: mesh and tensor_parallel are not ported yet")


class RecognizerTrainer:
    """Optimiser state and train step of a :class:`~..recognition.Recognizer`.

    Args:
        recognizer: the recognizer whose CRNN is trained, on its device.
        optimizer: a callable from the trainable parameters to a
            ``torch.optim.Optimizer``; default :class:`.optim.RMSprop` at
            1e-3, ``optax.rmsprop(1e-3)`` of the JAX trainer.
        mesh, tensor_parallel: the JAX trainer's multi-device layer; not
            ported, so anything but the defaults raises.
    """

    def __init__(self, recognizer, optimizer: typing.Optional[OptimizerFactory] = None,
                 mesh=None, tensor_parallel: bool = False):
        check_single_device(mesh, tensor_parallel)
        self.recognizer = recognizer
        self.model = recognizer.model
        self.device = recognizer.device
        factory = optimizer or (lambda params: RMSprop(params, lr=1e-3))
        self.optimizer = factory(trainable(self.model))
        self.generator = torch.Generator(device=self.device).manual_seed(0)

    @property
    def variables(self) -> dict:
        """The CRNN's variable tree (numpy copies, the JAX package's layout)."""
        return weights_lib.crnn_variables(self.model)

    @variables.setter
    def variables(self, variables: dict):
        self.recognizer.load_variables(variables)

    def train_step(self, batch, generator: typing.Optional[torch.Generator] = None) -> float:
        """One step on a batch of ``Recognizer.get_batch_generator``:
        ``((images, labels, input_length, label_length), y[, sample_weights])``.
        ``generator`` draws the dropout mask (default: the trainer's own).
        Returns the loss."""
        (images, labels, input_length, label_length), _y, *rest = batch
        weights = rest[0] if rest else np.ones((len(images),), dtype="float32")

        def tensor(array, dtype):
            return torch.as_tensor(np.asarray(array), dtype=dtype).to(self.device)

        dtype = self.model.fc_9.weight.dtype  # float32 unless converted
        images = tensor(images, dtype)
        labels = tensor(labels, torch.int64)
        input_length = tensor(input_length, torch.int64).reshape(-1)
        label_length = tensor(label_length, torch.int64).reshape(-1)
        weights = tensor(weights, dtype).reshape(-1)
        self.model.train()
        try:
            self.optimizer.zero_grad(set_to_none=True)
            logits = self.model(images, return_logits=True,
                                generator=self.generator if generator is None else generator)
            loss = torch.mean(ctc_loss(logits, labels, input_length, label_length) * weights)
            loss.backward()
            self.optimizer.step()
        finally:
            self.model.eval()
        return float(loss.detach())

    def fit(self, batch_generator, steps_per_epoch: int, epochs: int = 1,
            callbacks: typing.Optional[list] = None, seed: int = 0) -> typing.List[float]:
        """``epochs`` x ``steps_per_epoch`` steps with Keras-style callbacks
        at each epoch's end (``{"loss": mean step loss}``); the dropout
        masks come from a generator seeded with ``seed``. Returns the epoch
        losses."""
        return fit_loop(self, batch_generator, steps_per_epoch, epochs, callbacks,
                        torch.Generator(device=self.device).manual_seed(seed))


def fit_loop(trainer, batch_generator, steps_per_epoch, epochs, callbacks, *step_args):
    """The epoch loop both trainers share."""
    callbacks = CallbackList(callbacks or [], owner=trainer)
    history = []
    for epoch in range(epochs):
        losses = [trainer.train_step(next(batch_generator), *step_args)
                  for _ in range(steps_per_epoch)]
        epoch_loss = float(np.mean(losses))
        history.append(epoch_loss)
        if callbacks.on_epoch_end(epoch, {"loss": epoch_loss}):
            break
    return history
