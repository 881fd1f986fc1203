"""Training of the port: trainers, optimisers, callbacks, checkpoints.

The standard (unfolded) graphs in training mode, with autograd, on the
model's device or split over a mesh (:mod:`..parallel`). A model built with
``compute_dtype=torch.bfloat16`` trains as the JAX trainers train one: the
forward and backward round where the JAX modules round
(:mod:`..models.layers`), the parameters, their gradients and the
optimiser state stay float32, the inputs go in as float32.
"""

from . import callbacks, checkpoint, optim
from .detector import DetectorTrainer
from .recognizer import RecognizerTrainer

__all__ = ["DetectorTrainer", "RecognizerTrainer", "callbacks", "checkpoint", "optim"]
