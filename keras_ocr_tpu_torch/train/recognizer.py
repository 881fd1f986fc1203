"""CRNN recognizer training: CTC loss and RMSprop, on one device or a mesh.

Port of ``keras_ocr_tpu/train/recognizer.py``: one step runs the CRNN in
training mode (batch statistics, dropout) to pre-softmax frames, takes
``mean(ctc_loss * sample_weights)``, back-propagates and steps the
optimiser. The model is trained in place, so the recognizer (and a
``Pipeline`` built on it) reads with the new weights at once.

On a mesh (:mod:`..parallel.mesh`) the batch is split over its ``slice`` x
``data`` positions and each shard runs a replica
(:class:`..parallel.replicas.DataParallel`): BatchNorm takes the whole
batch's statistics, the frames are gathered on the model's device and the
loss is the global batch's, so the step is the one-device step on the whole
batch, as JAX's SPMD step is. ``tensor_parallel`` splits the kernels that
:func:`..parallel.mesh.crnn_param_sharding` puts on the ``model`` axis by
columns over that axis's devices. With ``mesh=None`` the step runs on the
model's device (JAX's default mesh is every device: the port's models carry
their device).

On a mesh across processes every process calls ``train_step`` with the
same global batch and runs its own positions: its loss is the sum over its
shards divided by the global count (its share of the global mean), the
BatchNorm sums are all-reduced, and after ``backward`` the gradients are
summed over the processes (one flat buffer per dtype) before the optimiser
steps, so every process returns the global loss and holds the same
parameters. A position's dropout generator is seeded by its global index,
whichever process holds it.
"""

from __future__ import annotations

import typing

import numpy as np
import torch

from .. import weights as weights_lib
from ..models.layers import full_float32
from ..ops.ctc import ctc_loss
from ..parallel import mesh as mesh_lib
from ..parallel.replicas import DataParallel, all_reduce_gradients, all_reduce_sum
from .callbacks import CallbackList
from .optim import RMSprop

OptimizerFactory = typing.Callable[[typing.List[torch.nn.Parameter]], torch.optim.Optimizer]


def trainable(model: torch.nn.Module) -> typing.List[torch.nn.Parameter]:
    """The parameters an optimiser may move (the CRNN's frozen ``bias_hh``
    excluded)."""
    return [param for param in model.parameters() if param.requires_grad]


def data_parallel(model: torch.nn.Module, mesh, configure=None) -> typing.Optional[DataParallel]:
    """The replicas of ``model`` on ``mesh`` (None without a mesh); a mesh
    that is not a :class:`..parallel.Mesh` raises ``TypeError``."""
    if mesh is None:
        return None
    return DataParallel(model, mesh_lib.check_mesh(mesh), configure)


def sharded_forward(parallel: DataParallel, images: torch.Tensor, device, kwargs=None):
    """The model's output on this process's part of the global batch
    ``images`` (all of it on a mesh of this process's devices): split over
    the data positions (``ValueError`` where it does not divide), each of
    this process's shards on its replica, the outputs gathered on
    ``device`` in batch order (:func:`local_part`)."""
    shards = [(shard,) for shard in mesh_lib.shard_batch(images, parallel.mesh)]
    return torch.cat([out.to(device) for out in parallel(shards, kwargs)])


def local_part(parallel: typing.Optional[DataParallel], *tensors):
    """The rows of ``tensors`` (each indexed by the global batch) that this
    process's positions hold, and their share of the batch: the tensors
    and 1 without a mesh across processes."""
    if parallel is None or not parallel.across_processes:
        return tensors, 1.0
    index = mesh_lib.local_indices(parallel.mesh, len(tensors[0]))
    return tuple(t[index.to(t.device)] for t in tensors), len(index) / len(tensors[0])


def finish_step(parallel: typing.Optional[DataParallel], model: torch.nn.Module,
                loss: torch.Tensor) -> float:
    """After ``backward``: across processes, every process's gradients
    summed into each one's (:func:`..parallel.replicas.all_reduce_gradients`)
    and the global loss (the sum of the shares); elsewhere the loss."""
    if parallel is None or not parallel.across_processes:
        return float(loss.detach())
    all_reduce_gradients(trainable(model))
    return float(all_reduce_sum(loss.detach().to(torch.float64)))


def position_generators(parallel: DataParallel, generator: torch.Generator) -> list:
    """One generator per data position of this process, seeded by the
    position's global index: one draw from ``generator`` for each of the
    mesh's positions in batch order, each seeding a generator on its
    position's device, kept where the position is this process's."""
    seeds = [torch.randint(0, 2**62, (1,), generator=generator, device=generator.device)
             for _ in range(mesh_lib.data_size(parallel.mesh))]
    return [torch.Generator(device=device).manual_seed(int(seeds[position]))
            for position, device in zip(parallel.positions, parallel.devices)]


def tensor_parallel_layers(model: torch.nn.Module, mesh) -> typing.List[str]:
    """The CRNN layers whose kernels :func:`..parallel.mesh.crnn_param_sharding`
    splits on ``mesh``'s ``model`` axis (none where that axis has one
    device)."""
    if mesh.shape.get("model", 1) == 1:
        return []
    specs = mesh_lib.crnn_param_sharding(mesh)(weights_lib.crnn_variables(model))["params"]
    return [name for name in ("fc_9", "fc_12", "lstm_10", "lstm_11")
            if specs[name]["kernel"].spec]


class RecognizerTrainer:
    """Optimiser state and train step of a :class:`~..recognition.Recognizer`.

    Args:
        recognizer: the recognizer whose CRNN is trained, on its device.
        optimizer: a callable from the trainable parameters to a
            ``torch.optim.Optimizer``; default :class:`.optim.RMSprop` at
            1e-3, ``optax.rmsprop(1e-3)`` of the JAX trainer.
        mesh: a :class:`..parallel.Mesh` to split each batch over (its
            ``slice`` x ``data`` positions must divide the batch), or None
            for the model's device.
        tensor_parallel: on a mesh whose ``model`` axis has several
            devices, split ``fc_9``, ``fc_12`` and the LSTM kernels by
            columns over them where the columns divide (otherwise that axis
            holds replicas that do not compute).
    """

    def __init__(self, recognizer, optimizer: typing.Optional[OptimizerFactory] = None,
                 mesh=None, tensor_parallel: bool = False):
        self.recognizer = recognizer
        self.model = recognizer.model
        self.device = recognizer.device
        self.mesh = mesh
        configure = None
        if tensor_parallel and mesh is not None:
            names = tensor_parallel_layers(self.model, mesh_lib.check_mesh(mesh))

            def configure(replica, row):
                replica.tensor_parallel = {getattr(replica, name): row for name in names}
        self.parallel = data_parallel(self.model, mesh, configure)
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
        ``generator`` draws the dropout mask (default: the trainer's own); on
        a mesh it seeds one generator per data position, in mesh order
        (:func:`position_generators`), and each shard draws its mask from
        its own. Returns the loss (the global batch's on every process)."""
        (images, labels, input_length, label_length), _y, *rest = batch
        weights = rest[0] if rest else np.ones((len(images),), dtype="float32")

        def tensor(array, dtype):
            return torch.as_tensor(np.asarray(array), dtype=dtype).to(self.device)

        # The parameters' dtype: float32 unless converted, also for a bf16
        # model (JAX passes float32 inputs).
        dtype = self.model.fc_9.weight.dtype
        images = tensor(images, dtype)
        labels = tensor(labels, torch.int64)
        input_length = tensor(input_length, torch.int64).reshape(-1)
        label_length = tensor(label_length, torch.int64).reshape(-1)
        weights = tensor(weights, dtype).reshape(-1)
        generator = self.generator if generator is None else generator
        self.model.train()
        try:
            self.optimizer.zero_grad(set_to_none=True)
            # The backward's convolutions and RNN in full float32 too.
            with full_float32():
                if self.parallel is None:
                    logits = self.model(images, return_logits=True, generator=generator)
                else:
                    logits = sharded_forward(self.parallel, images, self.device, [
                        {"return_logits": True, "generator": shard}
                        for shard in position_generators(self.parallel, generator)])
                (labels, input_length, label_length, weights), share = local_part(
                    self.parallel, labels, input_length, label_length, weights)
                loss = torch.mean(ctc_loss(logits, labels, input_length, label_length) * weights)
                if share != 1.0:
                    loss = loss * share
                loss.backward()
            loss = finish_step(self.parallel, self.model, loss)
            self.optimizer.step()
        finally:
            self.model.eval()
        return loss

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
