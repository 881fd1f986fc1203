"""Text detection: the CRAFT model facade of the port.

Counterpart of ``keras_ocr_tpu/detection.py:Detector`` for the fused
pipeline: it owns the CRAFT module on its device and the post-processing
caps. ``Detector.detect`` and the NumPy host oracle are not ported yet.
"""

from __future__ import annotations

import typing

import torch

from . import weights as weights_lib
from .models import CRAFT, init_parameters
from .models.craft import fold_bn_state_dict

# Ceiling of the component-cap escalation: the staircase tables are
# O(H x cap), so this bounds memory on noise-saturated heatmaps.
MAX_COMPONENTS_CEILING = 1024
# Ceiling of the labeling-sweep escalation; real heatmaps converge in 1-2
# sweeps and every call proves convergence.
MAX_SWEEPS_CEILING = 64
DEFAULT_NUM_SWEEPS = 8


def default_device() -> torch.device:
    """The first GPU; raises where there is none, so that nothing runs on
    the CPU unless the caller asks for it."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device=\"cpu\" to run on the CPU"
        )
    return torch.device("cuda")


class Detector:
    """CRAFT text detector.

    Args:
        weights: name of published pretrained weights. Their loaders are
            not ported yet, so only ``None`` (seeded random weights, or a
            variable tree passed to :meth:`load_variables`) is accepted.
        width: channel multiplier (1.0 = the reference graph).
        max_components: starting cap of the component escalation.
        fold_bn: build the inference graph with BatchNorm folded into the
            convolutions; on the card its convs run through the CUDA
            chain kernel (:mod:`keras_ocr_tpu_torch.ops.conv_cuda`).
        device: where the model runs (default: the first GPU; without
            one, pass ``device="cpu"`` or the constructor raises).
        seed: seed of the random initialisation.
    """

    def __init__(
        self,
        weights: typing.Optional[str] = None,
        width: float = 1.0,
        max_components: int = 256,
        fold_bn: bool = False,
        device=None,
        seed: int = 0,
    ):
        if width != 1.0 and weights is not None:
            raise ValueError(f"width={width} has no pretrained weights; pass weights=None")
        if weights is not None:
            raise NotImplementedError(
                f"pretrained weights {weights!r} cannot be loaded yet; use "
                "weights=None and load_variables()"
            )
        self.width = width
        self.max_components = max_components
        self.fold_bn = fold_bn
        self.device = torch.device(device) if device is not None else default_device()
        model = init_parameters(CRAFT(width=width, fold_bn=fold_bn), seed=seed)
        self.model = model.to(self.device).eval()

    def load_variables(self, variables: dict) -> "Detector":
        """Load a JAX-package CRAFT variable tree (numpy leaves). With
        ``fold_bn`` a standard tree is folded on load, as the JAX
        ``Detector`` folds the weights it loads; a folded tree loads as is."""
        state = weights_lib.craft_state_dict(variables)
        if self.fold_bn:
            state = fold_bn_state_dict(state)
        self.model.load_state_dict(state)
        return self
