"""Model zoo of the port: CRAFT detector and CRNN recognizer."""

from __future__ import annotations

import math

import torch
from torch import nn

from . import craft, crnn
from .craft import CRAFT
from .crnn import CRNN


def _lecun_normal_(weight, fan_in, generator):
    # Flax's default kernel init: truncated normal, variance 1 / fan_in.
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


@torch.no_grad()
def init_parameters(model: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded initialisation with the JAX package's initialiser families.

    Convs and dense layers: truncated LeCun normal weights and zero biases;
    BatchNorm: unit scale, zero shift, running mean 0 and variance 1; LSTMs:
    Glorot-uniform input kernels, orthogonal recurrent kernels, zero biases;
    the STN's last layer starts as the identity transform. The numbers
    differ from ``jax.random``'s for the same seed.
    """
    generator = torch.Generator().manual_seed(seed)
    for module in model.modules():
        if isinstance(module, nn.Conv2d):
            fan_in = module.in_channels * module.kernel_size[0] * module.kernel_size[1]
            _lecun_normal_(module.weight, fan_in, generator)
            nn.init.zeros_(module.bias)
        elif isinstance(module, nn.Linear):
            _lecun_normal_(module.weight, module.in_features, generator)
            nn.init.zeros_(module.bias)
        elif isinstance(module, nn.BatchNorm2d):
            module.reset_parameters()
        elif isinstance(module, nn.LSTM):
            for name, param in module.named_parameters():
                if name.startswith("weight_ih"):
                    nn.init.xavier_uniform_(param, generator=generator)
                elif name.startswith("weight_hh"):
                    # Keras's orthogonal (u, 4u) kernel, stored transposed.
                    kernel = torch.empty(param.shape[1], param.shape[0])
                    nn.init.orthogonal_(kernel, generator=generator)
                    param.copy_(kernel.T)
                else:
                    nn.init.zeros_(param)
    for module in model.modules():
        if isinstance(module, crnn.SpatialTransformer):
            nn.init.zeros_(module.dense2.weight)
            module.dense2.bias.copy_(
                torch.tensor([1.0, 0.0, 0.0, 0.0, 1.0, 0.0])
            )
    return model


__all__ = ["CRAFT", "CRNN", "craft", "crnn", "init_parameters"]
