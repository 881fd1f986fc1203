"""CRAFT text detector as a PyTorch module.

Port of ``keras_ocr_tpu/models/craft.py``: the same graph and the same
taps. ``s1``/``s2``/``s3`` are the post-ReLU outputs of ``slice1_10`` /
``slice2_17`` / ``slice3_27`` and ``s4`` is the pre-ReLU BatchNorm output of
``slice4_37``; the s5 head is a 3x3 stride-1 max-pool, a 3x3 dilation-6
conv and a 1x1 conv; the U-decoder resizes with half-pixel bilinear
sampling between stages; the cls head ends in two raw (no sigmoid) maps.

Inputs and outputs are NHWC like the JAX module; the convolutions run
NCHW inside. Module names follow the Flax tree, so a parameter's
``state_dict`` key is its Flax path joined with dots
(:mod:`keras_ocr_tpu_torch.weights`).
"""

from __future__ import annotations

import typing

import torch
from torch import nn
from torch.nn import functional as F

from ..ops.image import resize_bilinear

# (slice name, reference layer index of the conv, filters, pool after block)
VGG_BLOCKS: typing.Tuple[typing.Tuple[str, int, int, bool], ...] = (
    ("slice1", 0, 64, False),
    ("slice1", 3, 64, True),
    ("slice1", 7, 128, False),
    ("slice1", 10, 128, True),
    ("slice2", 14, 256, False),
    ("slice2", 17, 256, False),
    ("slice3", 20, 256, True),
    ("slice3", 24, 512, False),
    ("slice3", 27, 512, False),
    ("slice4", 30, 512, True),
    ("slice4", 34, 512, False),
    ("slice4", 37, 512, False),  # ends at BN (pre-ReLU) = s4 tap
)
_TAPS = {("slice1", 10): "s1", ("slice2", 17): "s2", ("slice3", 27): "s3"}


def _scaled(filters: int, width: float) -> int:
    """Width-multiplied channel count, floored to a multiple of 8."""
    if width == 1.0:
        return filters
    return max(8, int(filters * width) // 8 * 8)


class ConvBN(nn.Module):
    """Conv + BatchNorm (eps 1e-5) + optional ReLU; ``fold_bn`` drops the BN
    (its affine is then folded into the conv's weight and bias)."""

    def __init__(self, in_ch, out_ch, kernel=3, relu=True, fold_bn=False):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, kernel, padding="same")
        self.bn = None if fold_bn else nn.BatchNorm2d(out_ch, eps=1e-5)
        self.relu = relu

    def forward(self, x):
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        return F.relu(x) if self.relu else x


class VGG16BN(nn.Module):
    """VGG16-BN backbone emitting the four CRAFT skip taps (NCHW)."""

    def __init__(self, width=1.0, fold_bn=False):
        super().__init__()
        in_ch = 3
        self.order = []
        self.channels = {}
        for slice_name, idx, filters, _ in VGG_BLOCKS:
            name = f"{slice_name}_{idx}"
            out_ch = _scaled(filters, width)
            last = (slice_name, idx) == ("slice4", 37)
            self.add_module(name, ConvBN(in_ch, out_ch, 3, relu=not last, fold_bn=fold_bn))
            self.order.append(name)
            tap = "s4" if last else _TAPS.get((slice_name, idx))
            if tap:
                self.channels[tap] = out_ch
            in_ch = out_ch

    def forward(self, x):
        taps = {}
        for (slice_name, idx, _, pool), name in zip(VGG_BLOCKS, self.order):
            x = getattr(self, name)(x)
            tap = _TAPS.get((slice_name, idx))
            if tap:
                taps[tap] = x
            if pool:
                x = F.max_pool2d(x, 2, 2)
        taps["s4"] = x
        return taps["s1"], taps["s2"], taps["s3"], taps["s4"]


class UpConv(nn.Module):
    """1x1 conv-BN-ReLU + 3x3 conv-BN-ReLU decoder block (``filters // 2``
    output channels)."""

    def __init__(self, in_ch, filters, fold_bn=False):
        super().__init__()
        self.block0 = ConvBN(in_ch, filters, 1, fold_bn=fold_bn)
        self.block1 = ConvBN(filters, filters // 2, 3, fold_bn=fold_bn)

    def forward(self, x):
        return self.block1(self.block0(x))


class CRAFT(nn.Module):
    """Full CRAFT graph: (B, H, W, 3) normalised images -> (B, H/2, W/2, 2)."""

    def __init__(self, width: float = 1.0, fold_bn: bool = False):
        super().__init__()
        self.width = width
        self.fold_bn = fold_bn
        self.basenet = VGG16BN(width=width, fold_bn=fold_bn)
        ch = self.basenet.channels
        c5 = _scaled(1024, width)
        self.slice5_1 = nn.Conv2d(ch["s4"], c5, 3, padding="same", dilation=6)
        self.slice5_2 = nn.Conv2d(c5, c5, 1)
        up = [_scaled(f, width) for f in (512, 256, 128, 64)]
        self.upconv1 = UpConv(c5 + ch["s4"], up[0], fold_bn)
        self.upconv2 = UpConv(up[0] // 2 + ch["s3"], up[1], fold_bn)
        self.upconv3 = UpConv(up[1] // 2 + ch["s2"], up[2], fold_bn)
        self.upconv4 = UpConv(up[2] // 2 + ch["s1"], up[3], fold_bn)
        self.conv_cls_0 = nn.Conv2d(up[3] // 2, 32, 3, padding="same")
        self.conv_cls_2 = nn.Conv2d(32, 32, 3, padding="same")
        self.conv_cls_4 = nn.Conv2d(32, 16, 3, padding="same")
        self.conv_cls_6 = nn.Conv2d(16, 16, 1)
        self.conv_cls_8 = nn.Conv2d(16, 2, 1)

    def forward(self, x):
        # contiguous(): from a permuted NHWC tensor cuDNN runs every conv in
        # its channels-last fp32 kernels (CRAFT at batch 8 x 960x1280
        # measured 903 ms instead of 235 ms on an H100).
        x = x.to(torch.float32).permute(0, 3, 1, 2).contiguous()
        s1, s2, s3, s4 = self.basenet(x)
        s5 = F.max_pool2d(s4, 3, 1, padding=1)
        s5 = self.slice5_2(self.slice5_1(s5))

        def resize_to(y, skip):
            return resize_bilinear(y, skip.shape[2], skip.shape[3], dims=(2, 3))

        y = self.upconv1(torch.cat([s5, s4], 1))
        y = self.upconv2(torch.cat([resize_to(y, s3), s3], 1))
        y = self.upconv3(torch.cat([resize_to(y, s2), s2], 1))
        y = self.upconv4(torch.cat([resize_to(y, s1), s1], 1))
        y = F.relu(self.conv_cls_0(y))
        y = F.relu(self.conv_cls_2(y))
        y = F.relu(self.conv_cls_4(y))
        y = F.relu(self.conv_cls_6(y))
        y = self.conv_cls_8(y)
        return y.permute(0, 2, 3, 1)
