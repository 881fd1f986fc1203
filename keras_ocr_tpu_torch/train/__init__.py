"""Training of the port: trainers, optimisers, callbacks, checkpoints.

Float32, the standard (unfolded) graphs in training mode, with autograd,
on the model's device or split over a mesh (:mod:`..parallel`).
"""

from . import callbacks, checkpoint, optim
from .detector import DetectorTrainer
from .recognizer import RecognizerTrainer

__all__ = ["DetectorTrainer", "RecognizerTrainer", "callbacks", "checkpoint", "optim"]
