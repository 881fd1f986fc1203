"""Training of the port: trainers, optimisers, callbacks, checkpoints.

One device, fp32, the standard (unfolded) graphs in training mode, with
autograd; the multi-device layer of the JAX package is not ported yet.
"""

from . import callbacks, checkpoint, optim
from .detector import DetectorTrainer
from .recognizer import RecognizerTrainer

__all__ = ["DetectorTrainer", "RecognizerTrainer", "callbacks", "checkpoint", "optim"]
