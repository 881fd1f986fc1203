"""CRAFT detector training: heatmap loss and Adam on one device.

Port of ``keras_ocr_tpu/train/detector.py``. The default loss is the
reference's plain MSE over both heatmap channels; ``loss="ohem"`` is the
CRAFT paper's online hard-example mining. The standard graph trains (the
BN-folded one is inference only) with cuDNN's convolutions and autograd.
"""

from __future__ import annotations

import typing

import numpy as np
import torch

from .. import weights as weights_lib
from .optim import adam
from .recognizer import OptimizerFactory, check_single_device, fit_loop, trainable


def _mse_loss(preds, targets, sample_weights):
    """The reference's objective: plain MSE over both channels."""
    per_sample = torch.mean((preds - targets) ** 2, dim=(1, 2, 3))
    return torch.mean(per_sample * sample_weights)


def ohem_mse_loss(preds, targets, sample_weights, pos_threshold: float = 0.1,
                  neg_ratio: int = 3, min_negatives: int = 512):
    """CRAFT online hard-example-mining pixel loss, per channel.

    For each sample and heatmap channel: every pixel whose target exceeds
    ``pos_threshold`` counts, plus the ``neg_ratio`` x positives largest
    negative errors (``min_negatives`` where the map has no positive),
    normalised by the pixels that count. The top-k is a full sort and a
    rank mask, as in the JAX package.
    """
    batch = preds.shape[0]
    dtype = torch.promote_types(preds.dtype, torch.float32)
    err = (preds.to(dtype) - targets.to(dtype)) ** 2
    # (B, H, W, C) -> (B, C, N): each channel on its own.
    err = err.reshape(batch, -1, err.shape[-1]).transpose(1, 2)
    pos = targets.reshape(batch, -1, targets.shape[-1]).transpose(1, 2) > pos_threshold
    n_pixels = err.shape[-1]
    n_pos = pos.sum(-1)
    n_neg = n_pixels - n_pos
    k = torch.where(n_pos > 0, torch.minimum(neg_ratio * n_pos, n_neg),
                    n_neg.clamp(max=min_negatives))
    pos_sum = torch.where(pos, err, 0.0).sum(-1)
    # Positives sink below every negative (err >= 0 > -1), and k <= n_neg
    # keeps the -1 fill out of the top k.
    neg_sorted = torch.sort(torch.where(pos, -1.0, err), dim=-1, descending=True).values
    ranks = torch.arange(n_pixels, device=err.device)
    neg_sum = torch.where(ranks < k[..., None], neg_sorted, 0.0).sum(-1)
    per_channel = (pos_sum + neg_sum) / (n_pos + k).clamp(min=1)
    return torch.mean(per_channel.mean(-1) * sample_weights)


class DetectorTrainer:
    """Optimiser state and train step of a :class:`~..detection.Detector`.

    Args:
        detector: a standard (``fold_bn=False``) detector, on its device.
        optimizer: a callable from the parameters to a
            ``torch.optim.Optimizer``; default :func:`.optim.adam` at 1e-3.
        mesh: the JAX trainer's mesh; not ported, so only None.
        loss: ``"mse"``, ``"ohem"`` or a callable ``(preds, targets,
            sample_weights) -> scalar`` on tensors.
    """

    def __init__(self, detector, optimizer: typing.Optional[OptimizerFactory] = None,
                 mesh=None, loss: typing.Union[str, typing.Callable] = "mse"):
        check_single_device(mesh)
        if detector.fold_bn:
            raise ValueError("fold_bn=True is an inference-only graph; train a standard "
                             "Detector and fold its weights afterwards")
        if callable(loss):
            self.loss = loss
        elif loss == "mse":
            self.loss = _mse_loss
        elif loss == "ohem":
            self.loss = ohem_mse_loss
        else:
            raise ValueError(f"unknown loss {loss!r}; use 'mse', 'ohem', or a callable")
        self.detector = detector
        self.model = detector.model
        self.device = detector.device
        factory = optimizer or (lambda params: adam(params, lr=1e-3))
        self.optimizer = factory(trainable(self.model))

    @property
    def variables(self) -> dict:
        """CRAFT's variable tree (numpy copies, the JAX package's layout)."""
        return weights_lib.craft_variables(self.model)

    @variables.setter
    def variables(self, variables: dict):
        self.detector.load_variables(variables)

    def train_step(self, batch) -> float:
        """One step on ``(images, targets[, sample_weights])`` of
        ``Detector.get_batch_generator``: normalised (B, H, W, 3) images and
        (B, H/2, W/2, 2) maps. Returns the loss."""
        images, targets, *rest = batch
        weights = rest[0] if rest else np.ones((len(images),), dtype="float32")

        dtype = next(self.model.parameters()).dtype  # float32 unless converted

        def tensor(array):
            return torch.as_tensor(np.asarray(array), dtype=dtype).to(self.device)

        images, targets, weights = tensor(images), tensor(targets), tensor(weights).reshape(-1)
        self.model.train()
        try:
            self.optimizer.zero_grad(set_to_none=True)
            loss = self.loss(self.model(images), targets, weights)
            loss.backward()
            self.optimizer.step()
        finally:
            self.model.eval()
        return float(loss.detach())

    def fit(self, batch_generator, steps_per_epoch: int, epochs: int = 1,
            callbacks: typing.Optional[list] = None) -> typing.List[float]:
        """``epochs`` x ``steps_per_epoch`` steps with Keras-style callbacks
        at each epoch's end. Returns the epoch losses."""
        return fit_loop(self, batch_generator, steps_per_epoch, epochs, callbacks)
