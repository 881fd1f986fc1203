"""Text recognition: the CRNN model facade of the port.

Counterpart of ``keras_ocr_tpu/recognition.py:Recognizer`` for the fused
pipeline. ``Recognizer.recognize`` / ``recognize_from_boxes`` and the
published-weight loaders are not ported yet.
"""

from __future__ import annotations

import string
import typing

import torch

from . import weights as weights_lib
from .detection import default_device
from .models import CRNN, init_parameters
from .models.crnn import DEFAULT_BUILD_PARAMS

DEFAULT_ALPHABET = string.digits + string.ascii_lowercase


class Recognizer:
    """CRNN text recognizer.

    Args:
        weights: name of published pretrained weights; not loadable yet,
            so only ``None`` (seeded random weights, or a variable tree
            passed to :meth:`load_variables`) is accepted.
        alphabet: the character set (default digits + lowercase).
        build_params: CRNN build parameters (default
            :data:`~keras_ocr_tpu_torch.models.crnn.DEFAULT_BUILD_PARAMS`).
        device: where the model runs (default: the first GPU; without
            one, pass ``device="cpu"`` or the constructor raises).
        seed: seed of the random initialisation.
    """

    def __init__(
        self,
        weights: typing.Optional[str] = None,
        alphabet: typing.Optional[str] = None,
        build_params: typing.Optional[dict] = None,
        device=None,
        seed: int = 0,
    ):
        if weights is not None:
            raise NotImplementedError(
                f"pretrained weights {weights!r} cannot be loaded yet; use "
                "weights=None and load_variables()"
            )
        self.alphabet = alphabet or DEFAULT_ALPHABET
        self.build_params = dict(build_params or DEFAULT_BUILD_PARAMS)
        params = self.build_params
        channels = 3 if params["color"] else 1
        self.input_shape = (params["height"], params["width"], channels)
        self.device = torch.device(device) if device is not None else default_device()
        model = CRNN(
            alphabet_size=len(self.alphabet),
            height=params["height"],
            width=params["width"],
            color=params["color"],
            filters=tuple(params["filters"]),
            rnn_units=tuple(params["rnn_units"]),
            dropout=params["dropout"],
            rnn_steps_to_discard=params["rnn_steps_to_discard"],
            pool_size=params["pool_size"],
            stn=params["stn"],
        )
        self.model = init_parameters(model, seed=seed).to(self.device).eval()

    def load_variables(self, variables: dict) -> "Recognizer":
        """Load a JAX-package CRNN variable tree (numpy leaves)."""
        self.model.load_state_dict(weights_lib.crnn_state_dict(variables))
        return self
