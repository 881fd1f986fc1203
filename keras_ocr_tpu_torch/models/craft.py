"""CRAFT text detector as a PyTorch module.

Port of ``keras_ocr_tpu/models/craft.py``: the same graph and the same
taps. ``s1``/``s2``/``s3`` are the post-ReLU outputs of ``slice1_10`` /
``slice2_17`` / ``slice3_27`` and ``s4`` is the pre-ReLU BatchNorm output of
``slice4_37``; the s5 head is a 3x3 stride-1 max-pool, a 3x3 dilation-6
conv and a 1x1 conv; the U-decoder resizes with half-pixel bilinear
sampling between stages; the cls head ends in two raw (no sigmoid) maps.

Inputs and outputs are NHWC like the JAX module. The standard graph runs
its convolutions NCHW inside (cuDNN). The BN-folded graph
(``fold_bn=True``, inference only) stays NHWC and runs every conv but the
s5 head as :func:`keras_ocr_tpu_torch.ops.conv_cuda.conv_chain` calls:
the hand-written CUDA kernel on the card, ``F.conv2d`` on the CPU.
Training mode (``model.train()``) is the JAX module's ``train=True``: the
BatchNorms normalise with batch statistics and keep their running ones as
Flax does (:class:`.layers.BatchNorm2d`, torch momentum 0.1 = Flax 0.9);
the folded graph refuses it. Module names follow the Flax tree, so a
parameter's ``state_dict`` key is its Flax path joined with dots
(:mod:`keras_ocr_tpu_torch.weights`); the folded graph keeps the same
``conv`` keys and has no ``bn`` ones (:func:`fold_bn_state_dict`).
"""

from __future__ import annotations

import typing

import torch
from torch import nn
from torch.nn import functional as F

from ..ops import conv_cuda
from ..ops.image import resize_bilinear
from .layers import BatchNorm2d

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


def _chain_conv(conv: nn.Conv2d, relu: bool):
    """(HWIO weight, bias, relu) of one layer of a :func:`conv_chain`. The
    OIHW -> HWIO copies move about 40 MB per full-width forward, against
    its 819 GFLOP of convolutions."""
    return conv.weight.detach().permute(2, 3, 1, 0).contiguous(), conv.bias.detach(), relu


def fold_bn_state_dict(state: dict, eps: float = 1e-5) -> dict:
    """Fold every ConvBN pair's BatchNorm into its conv.

    Counterpart of ``keras_ocr_tpu/models/craft.py:fold_bn_variables`` on a
    ``CRAFT`` state_dict: for each ``<p>.bn.*`` group, with
    ``inv = gamma / sqrt(var + eps)``, ``<p>.conv.weight`` is scaled by
    ``inv`` along its output channels (OIHW) and ``<p>.conv.bias`` becomes
    ``(bias - mean) * inv + beta``; the ``bn`` keys are dropped. The result
    loads into ``CRAFT(fold_bn=True)``.
    """
    folded = {k: v for k, v in state.items() if ".bn." not in k}
    for key in state:
        if not key.endswith(".bn.weight"):
            continue
        prefix = key[: -len(".bn.weight")]
        inv = state[key] / torch.sqrt(state[f"{prefix}.bn.running_var"] + eps)
        weight = state[f"{prefix}.conv.weight"]
        folded[f"{prefix}.conv.weight"] = weight * inv.reshape(-1, 1, 1, 1)
        folded[f"{prefix}.conv.bias"] = (
            state[f"{prefix}.conv.bias"] - state[f"{prefix}.bn.running_mean"]
        ) * inv + state[f"{prefix}.bn.bias"]
    return folded


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
        self.bn = None if fold_bn else BatchNorm2d(out_ch, eps=1e-5)
        self.relu = relu

    def forward(self, x):
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        return F.relu(x) if self.relu else x

    def chain_conv(self):
        return _chain_conv(self.conv, self.relu)


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

    def forward_folded(self, x):
        """The BN-folded backbone on NHWC ``x``: one conv chain up to each
        pool or tap (seven chains at CRAFT's layout)."""
        taps, blocks = {}, []
        for (slice_name, idx, _, pool), name in zip(VGG_BLOCKS, self.order):
            blocks.append(getattr(self, name))
            tap = _TAPS.get((slice_name, idx))
            if not (pool or tap or name == self.order[-1]):
                continue
            convs = [block.chain_conv() for block in blocks]
            blocks = []
            x = conv_cuda.conv_chain(x, convs, pool=pool, tap_prepool=bool(tap and pool))
            if tap and pool:
                x, taps[tap] = x
            elif tap:
                taps[tap] = x
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

    def forward_folded(self, x):
        return conv_cuda.conv_chain(x, [self.block0.chain_conv(), self.block1.chain_conv()])


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
        if self.fold_bn:
            if self.training:
                raise ValueError("fold_bn=True is an inference-only graph")
            return self._forward_folded(x)
        # contiguous(): from a permuted NHWC tensor cuDNN runs every conv in
        # its channels-last fp32 kernels (CRAFT at batch 8 x 960x1280
        # measured 903 ms instead of 235 ms on an H100). The standard graph
        # computes in its parameters' dtype (float32 unless converted).
        x = x.to(self.slice5_1.weight.dtype).permute(0, 3, 1, 2).contiguous()
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

    def _forward_folded(self, x):
        """Inference graph with BatchNorm folded: NHWC throughout, 12 conv
        chains; the s5 head (a dilated conv neither kernel takes) stays
        cuDNN on a contiguous NCHW copy."""
        x = x.to(torch.float32).contiguous()
        s1, s2, s3, s4 = self.basenet.forward_folded(x)
        s5 = F.max_pool2d(s4.permute(0, 3, 1, 2).contiguous(), 3, 1, padding=1)
        s5 = self.slice5_2(self.slice5_1(s5)).permute(0, 2, 3, 1).contiguous()

        def resize_to(y, skip):
            return resize_bilinear(y, skip.shape[1], skip.shape[2])

        y = self.upconv1.forward_folded(torch.cat([s5, s4], -1))
        y = self.upconv2.forward_folded(torch.cat([resize_to(y, s3), s3], -1))
        y = self.upconv3.forward_folded(torch.cat([resize_to(y, s2), s2], -1))
        y = self.upconv4.forward_folded(torch.cat([resize_to(y, s1), s1], -1))
        head = [(self.conv_cls_0, True), (self.conv_cls_2, True), (self.conv_cls_4, True),
                (self.conv_cls_6, True), (self.conv_cls_8, False)]
        return conv_cuda.conv_chain(y, [_chain_conv(conv, relu) for conv, relu in head])
