"""EfficientNet B0-B7 backbone for the CRAFT detector.

Port of ``keras_ocr_tpu/models/efficientnet.py``: MBConv blocks with
squeeze-excite and swish, width and depth scaling, filters rounded to
multiples of 8, BatchNorm epsilon 1e-3. The backbone returns the four CRAFT
taps, the expand activations of ``block2a`` .. ``block5a`` (the 1x1
expansion conv + BN + swish of the first block of stages 2-5, at H/2, H/4,
H/8 and H/16), NCHW like :class:`.craft.VGG16BN`.

Three things follow the Flax modules rather than torch's defaults:

- TF "SAME" padding. A strided conv pads ``total // 2`` before and the rest
  after (:class:`SameConv2d`), so an even input gets (0, 1) around a 3x3
  stride-2 kernel and (1, 2) around a 5x5 one; ``padding=k // 2`` would
  shift the sampling grid by a pixel.
- BatchNorm momentum: the JAX modules pass none, so Flax's 0.99 applies,
  torch momentum 0.01 (CRAFT's own BatchNorms use 0.1).
- The JAX backbone calls the first block of stages 2-5 twice, once for its
  tap and once for its output. The port computes the expand once, but in
  training it folds the batch statistics of that block's ``expand_bn`` into
  the running ones twice, as the two Flax calls do; and it runs the rest of
  stage 5, whose output no tap reads, in training only, for the running
  statistics those Flax calls update.

A bfloat16 input runs the whole backbone in bfloat16 with float32
parameters, rounding as the Flax modules do (:mod:`.layers`).

The backbone runs on a row strip of the images (:mod:`..parallel.halo`,
the pipeline's spatial sharding) as it runs whole: each depthwise conv and
the stem take the rows they read across the strip's edges from the
neighbouring strips, a strided one with the whole image's "SAME" pads at
the image's top and bottom only (:func:`..parallel.halo.same_rows`), and
each squeeze-excite mean adds every strip's sums
(:func:`..parallel.halo.mean`): two meetings a block. The 1x1 convs read
no other rows. Strip bounds on multiples of 16 rows keep every strided
conv's output rows whole, and the last strip's remainder gives the whole
image's ``ceil``.

Module names follow the Flax tree (``stem.Conv_0``, ``block2a.expand_conv``,
``block2a.dw_bn``, ...), so a ``state_dict`` key is the Flax path joined
with dots. Stages 6-7 are never built.
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F

from ..parallel import halo
from .layers import BatchNorm2d, Conv2d, sigmoid, swish

# (width_multiplier, depth_multiplier) per variant.
SCALING = {
    "efficientnetb0": (1.0, 1.0),
    "efficientnetb1": (1.0, 1.1),
    "efficientnetb2": (1.1, 1.2),
    "efficientnetb3": (1.2, 1.4),
    "efficientnetb4": (1.4, 1.8),
    "efficientnetb5": (1.6, 2.2),
    "efficientnetb6": (1.8, 2.6),
    "efficientnetb7": (2.0, 3.1),
}

# (kernel, stride, expand_ratio, filters, repeats) for B0's seven stages.
BASE_STAGES = (
    (3, 1, 1, 16, 1),
    (3, 2, 6, 24, 2),
    (5, 2, 6, 40, 2),
    (3, 2, 6, 80, 3),
    (5, 1, 6, 112, 3),
    (5, 2, 6, 192, 4),
    (3, 1, 6, 320, 1),
)
# The stages whose first block's expand activation is a CRAFT tap; the
# backbone ends with the last of them.
TAP_STAGES = (2, 3, 4, 5)

BN_EPS = 1e-3
BN_MOMENTUM = 0.01  # Flax's default 0.99


def round_filters(filters: int, width: float, divisor: int = 8) -> int:
    filters *= width
    new_filters = max(divisor, int(filters + divisor / 2) // divisor * divisor)
    if new_filters < 0.9 * filters:
        new_filters += divisor
    return int(new_filters)


def round_repeats(repeats: int, depth: float) -> int:
    return int(math.ceil(depth * repeats))


def blocks(model_name: str):
    """``(stage, block name, stride, kernel, expand_ratio, filters_out)`` of
    every block of stages 1-5, in order."""
    width, depth = SCALING[model_name.lower()]
    for stage, (kernel, stride, expand, filters, repeats) in enumerate(BASE_STAGES[:5], 1):
        for index in range(round_repeats(repeats, depth)):
            yield (stage, f"block{stage}{chr(ord('a') + index)}", stride if index == 0 else 1,
                   kernel, expand, round_filters(filters, width))


def _bn(channels):
    return BatchNorm2d(channels, eps=BN_EPS, momentum=BN_MOMENTUM)


class SameConv2d(Conv2d):
    """``nn.Conv2d`` with TF/Flax "SAME" padding: the output has
    ``ceil(size / stride)`` rows and columns, and a strided conv pads
    ``total // 2`` before and the rest after, from the input's size
    (:func:`..parallel.halo.same_pads`). On a row strip a conv wider than
    a row takes its halo rows from the neighbouring strips, and a strided
    one pads rows from the whole image's height, at its edges only."""

    def __init__(self, in_ch, out_ch, kernel, stride=1, groups=1, bias=False):
        # Stride 1 with an odd kernel pads k // 2 on both sides: the
        # built-in padding does that without a copy.
        super().__init__(in_ch, out_ch, kernel, stride=stride, groups=groups, bias=bias,
                         padding=kernel // 2 if stride == 1 else 0)

    def forward(self, x):
        (kh, kw), (sh, sw) = self.kernel_size, self.stride
        if kh > 1 and halo.current() is not None:
            if sh == 1:
                # The built-in padding pads the image's edges; the rows it
                # pads at an inner edge are cropped.
                return halo.apply(super().forward, x, kh // 2, dim=2)
            x = F.pad(halo.same_rows(x, kh, sh, dim=2), halo.same_pads(x.shape[3], kw, sw))
        elif sh > 1:
            x = F.pad(x, halo.same_pads(x.shape[3], kw, sw) + halo.same_pads(x.shape[2], kh, sh))
        return super().forward(x)


class ConvBNSwish(nn.Module):
    """The stem: a 3x3 stride-2 conv (no bias), BatchNorm and swish."""

    def __init__(self, in_ch, features, kernel, stride=1):
        super().__init__()
        self.Conv_0 = SameConv2d(in_ch, features, kernel, stride)
        self.BatchNorm_0 = _bn(features)

    def forward(self, x):
        return swish(self.BatchNorm_0(self.Conv_0(x)))


class MBConv(nn.Module):
    """Mobile inverted bottleneck with squeeze-excitation.

    ``forward`` returns the expand activation and the block's output
    together. ``expand_updates`` is how many times a training call folds
    the batch statistics of ``expand_bn`` into its running ones (2 for a
    tap block: the JAX backbone runs that expand twice).
    """

    def __init__(self, in_ch, filters_out, kernel, stride, expand_ratio, se_ratio=0.25,
                 expand_updates=1):
        super().__init__()
        expanded = in_ch * expand_ratio
        self.residual = stride == 1 and in_ch == filters_out
        if expand_ratio != 1:
            self.expand_conv = SameConv2d(in_ch, expanded, 1)
            self.expand_bn = _bn(expanded)
            self.expand_bn.updates_per_call = expand_updates
        else:
            self.expand_conv = self.expand_bn = None
        self.dwconv = SameConv2d(expanded, expanded, kernel, stride, groups=expanded)
        self.dw_bn = _bn(expanded)
        # The squeeze width comes from the block's input channels.
        se_channels = max(1, int(in_ch * se_ratio))
        self.se_reduce = Conv2d(expanded, se_channels, 1)
        self.se_expand = Conv2d(se_channels, expanded, 1)
        self.project_conv = SameConv2d(expanded, filters_out, 1)
        self.project_bn = _bn(filters_out)

    def expand(self, x):
        if self.expand_conv is None:
            return x
        return swish(self.expand_bn(self.expand_conv(x)))

    def forward(self, x):
        expanded = self.expand(x)
        return expanded, self.rest(expanded, x)

    def rest(self, expanded, x):
        """The block's output from its input ``x`` and its expand
        activation."""
        y = swish(self.dw_bn(self.dwconv(expanded)))
        # On a row strip the mean is the whole image's: one meeting.
        se = swish(self.se_reduce(halo.mean(y, (2, 3), dim=2)))
        y = y * sigmoid(self.se_expand(se))
        y = self.project_bn(self.project_conv(y))
        if self.residual:
            y = y + x
        return y


class EfficientNetBackbone(nn.Module):
    """EfficientNet emitting the four CRAFT skip taps (NCHW); ``channels``
    names each tap's width, as :class:`.craft.VGG16BN`'s does. ``dtype``
    is the JAX module's: ``torch.bfloat16`` computes in bfloat16 with
    float32 parameters whatever the input's dtype; otherwise the backbone
    computes in its input's."""

    def __init__(self, model_name: str = "efficientnetb0", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.model_name = model_name.lower()
        self.dtype = dtype
        width, _ = SCALING[self.model_name]
        in_ch = round_filters(32, width)
        self.stem = ConvBNSwish(3, in_ch, kernel=3, stride=2)
        self.order = []
        self.channels = {}
        for stage, name, stride, kernel, expand, filters_out in blocks(self.model_name):
            tap = stage in TAP_STAGES and name.endswith("a")
            self.add_module(name, MBConv(in_ch, filters_out, kernel, stride, expand,
                                         expand_updates=2 if tap else 1))
            if tap:
                self.channels[f"s{len(self.channels) + 1}"] = in_ch * expand
            self.order.append((name, tap))
            in_ch = filters_out
        self.last_tap = [name for name, tap in self.order if tap][-1]

    def forward(self, x):
        if self.dtype == torch.bfloat16:
            x = x.to(self.dtype)
        x = self.stem(x)
        taps = []
        for name, tap in self.order:
            block = getattr(self, name)
            if name == self.last_tap:
                taps.append(block.expand(x))
                if self.training:
                    # Nothing reads the rest of stage 5; in training it
                    # runs for the running statistics the JAX backbone
                    # updates there.
                    with torch.no_grad():
                        self._rest_of_stage(taps[-1], x)
                break
            expanded, x = block(x)
            if tap:
                taps.append(expanded)
        return tuple(taps)

    def _rest_of_stage(self, expanded, x):
        names = [name for name, _ in self.order]
        start = names.index(self.last_tap)
        x = getattr(self, self.last_tap).rest(expanded, x)
        for name in names[start + 1:]:
            _, x = getattr(self, name)(x)
