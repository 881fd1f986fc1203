"""CRAFT text detector as a PyTorch module.

Port of ``keras_ocr_tpu/models/craft.py``: the same graph and the same
taps. ``s1``/``s2``/``s3`` are the post-ReLU outputs of ``slice1_10`` /
``slice2_17`` / ``slice3_27`` and ``s4`` is the pre-ReLU BatchNorm output of
``slice4_37``; the s5 head is a 3x3 stride-1 max-pool, a 3x3 dilation-6
conv and a 1x1 conv; the U-decoder resizes with half-pixel bilinear
sampling between stages; the cls head ends in two raw maps for the VGG
backbone and in a sigmoid for the EfficientNet ones
(:mod:`.efficientnet`), whose tap widths size the s5 head and the decoder.

Inputs and outputs are NHWC like the JAX module. The standard graph runs
its convolutions NCHW inside (cuDNN). The BN-folded graph
(``fold_bn=True``, inference only) stays NHWC and runs every conv but the
s5 head as :func:`keras_ocr_tpu_torch.ops.conv_cuda.conv_chain` calls:
the hand-written CUDA kernel on the card, ``F.conv2d`` on the CPU.
Both graphs run the VGG backbone as the same conv chains (the layers up to
each pool or tap) and can run on a row strip of the images
(:mod:`..parallel.halo`): each chain, the s5 head, each decoder block and
the cls head then take the rows their 3x3 and dilated convs and 3x3
max-pool read across the strip's edges from the neighbouring strips, and
each resize the rows its taps read; outside a strip forward they run as
they are. The EfficientNet backbones run on strips too
(:mod:`.efficientnet`: halo rows for the depthwise convs, the whole
image's pads for the strided ones, whole-image squeeze-excite means).
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
from ..ops.image import resize_bilinear  # noqa: F401 (JAX's models.craft binds it)
from ..parallel import halo
from .efficientnet import EfficientNetBackbone
from .layers import BatchNorm2d, Conv2d, float32_output, full_float32, sigmoid

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
    """(HWIO weight, bias, relu) of one layer of a :func:`conv_chain`.

    The OIHW -> HWIO copy is kept on the module and made anew when the
    weight's identity, version, storage, device or dtype changes
    (``load_state_dict``, an in-place update, ``.to(...)``), so the same
    tensor reaches the conv kernel every forward and its operand, cached
    on that tensor (:func:`..ops.conv_cuda.prepared_weight`), is made once.
    A traced forward (``torch.export``) and inference-tensor weights take a
    fresh copy each time."""
    weight = conv.weight
    if torch.compiler.is_compiling() or weight.is_inference():
        return weight.detach().permute(2, 3, 1, 0).contiguous(), conv.bias.detach(), relu
    key = (id(weight), weight._version, weight.data_ptr(), weight.device, weight.dtype)
    cached = conv.__dict__.get("_chain_hwio")
    if cached is None or cached[0] != key:
        # Outside inference mode, so that the copy keeps a version counter.
        with torch.inference_mode(False):
            hwio = weight.detach().permute(2, 3, 1, 0).contiguous()
        cached = conv.__dict__["_chain_hwio"] = (key, hwio)
    return cached[1], conv.bias.detach(), relu


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


def fold_bn_variables(variables: dict, eps: float = 1e-5) -> dict:
    """Counterpart of ``keras_ocr_tpu/models/craft.py:fold_bn_variables``:
    the fold of every ConvBN pair's BatchNorm into its conv, on a JAX-layout
    variable tree (numpy copies, for ``Detector(fold_bn=True)``), through
    :func:`fold_bn_state_dict`."""
    from .. import weights

    return weights.craft_variables(
        fold_bn_state_dict(weights.craft_state_dict(variables), eps))


def _scaled(filters: int, width: float) -> int:
    """Width-multiplied channel count, floored to a multiple of 8."""
    if width == 1.0:
        return filters
    return max(8, int(filters * width) // 8 * 8)


class PerImageConv2d(Conv2d):
    """``nn.Conv2d`` that convolves a batch one image at a time.

    For ``upconv2.block1`` (3x3, 256 -> 128 channels) cuDNN 9's float32
    heuristics pick an FFT convolution at some batch sizes, NCHW and NHWC
    alike: at 120x160 (a 960x1280 input) batches 2-7 take 270-504 ms
    against 0.58 ms at batch 1, and batch 8 17.3 ms; at 64x80 batches 5-7
    (``scripts/craft_batch_sweep.py``, an H100). One image at a time keeps
    batch 1's implicit GEMM at every batch (3.9 ms at batch 8), with each
    image's output bit for bit what it is alone. Same parameters and keys
    as ``nn.Conv2d``; training, autograd and the BatchNorm after it see the
    whole batch as before. The images' gradients of a parameter add up in
    one view of it and reach the parameter once a forward, so that the
    replicas of a mesh add theirs in the same order however the positions
    lie over devices and processes."""

    def forward(self, x):
        if x.shape[0] <= 1:
            return super().forward(x)
        weight = self.weight.view_as(self.weight)
        bias = None if self.bias is None else self.bias.view_as(self.bias)
        return torch.cat([self._conv_forward(image, weight, bias) for image in x.split(1)])


class ConvBN(nn.Module):
    """Conv + BatchNorm (eps 1e-5) + optional ReLU; ``fold_bn`` drops the BN
    (its affine is then folded into the conv's weight and bias);
    ``per_image`` makes the conv a :class:`PerImageConv2d`."""

    def __init__(self, in_ch, out_ch, kernel=3, relu=True, fold_bn=False, per_image=False):
        super().__init__()
        conv = PerImageConv2d if per_image else Conv2d
        self.conv = conv(in_ch, out_ch, kernel, padding="same")
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

    def chains(self):
        """(blocks, pool, tap) of each conv chain: the blocks up to each
        pool or tap (seven chains at CRAFT's layout), whether a 2x2 pool
        follows, and the tap's name or None."""
        blocks = []
        for (slice_name, idx, _, pool), name in zip(VGG_BLOCKS, self.order):
            blocks.append(getattr(self, name))
            tap = _TAPS.get((slice_name, idx))
            if pool or tap or name == self.order[-1]:
                yield blocks, pool, tap
                blocks = []

    def forward(self, x):
        taps = {}
        for blocks, pool, tap in self.chains():
            # One halo of a row per 3x3 conv; the pool after the crop sees
            # whole row pairs, since strips start at even rows.
            x = halo.apply(lambda t: _run(blocks, t), x, len(blocks), dim=2)
            if tap:
                taps[tap] = x
            if pool:
                x = F.max_pool2d(x, 2, 2)
        taps["s4"] = x
        return taps["s1"], taps["s2"], taps["s3"], taps["s4"]

    def forward_folded(self, x):
        """The BN-folded backbone on NHWC ``x``: one conv chain a chain of
        :meth:`chains`. On a strip a pooled chain takes an even halo, so
        that its fused pool pairs the rows as the whole image's does."""
        taps = {}
        for blocks, pool, tap in self.chains():
            convs = [block.chain_conv() for block in blocks]
            both = bool(tap and pool)
            x = halo.apply(
                lambda t: conv_cuda.conv_chain(t, convs, pool=pool, tap_prepool=both),
                x, -(-len(convs) // 2) * 2 if pool else len(convs), dim=1,
                shrink=(2, 1) if both else (2 if pool else 1))
            if both:
                x, taps[tap] = x
            elif tap:
                taps[tap] = x
        taps["s4"] = x
        return taps["s1"], taps["s2"], taps["s3"], taps["s4"]


def _run(modules, x):
    for module in modules:
        x = module(x)
    return x


class UpConv(nn.Module):
    """1x1 conv-BN-ReLU + 3x3 conv-BN-ReLU decoder block (``filters // 2``
    output channels); ``per_image`` runs the 3x3 conv one image at a time."""

    def __init__(self, in_ch, filters, fold_bn=False, per_image=False):
        super().__init__()
        self.block0 = ConvBN(in_ch, filters, 1, fold_bn=fold_bn)
        self.block1 = ConvBN(filters, filters // 2, 3, fold_bn=fold_bn, per_image=per_image)

    def forward(self, x):
        return self.block1(self.block0(x))

    def forward_folded(self, x):
        return conv_cuda.conv_chain(x, [self.block0.chain_conv(), self.block1.chain_conv()])


class CRAFT(nn.Module):
    """Full CRAFT graph: (B, H, W, 3) normalised images -> (B, H/2, W/2, 2).

    ``backbone_name`` is ``"vgg"`` or one of ``efficientnetb0`` ..
    ``efficientnetb7`` (any case); ``fold_bn`` and ``width`` apply to the
    VGG graph only, as in the JAX module. ``dtype`` is the JAX module's:
    ``torch.bfloat16`` computes in bfloat16 with float32 parameters,
    rounding where Flax does (:mod:`.layers`; the BN-folded graph where the
    TPU conv kernel does, once per layer), and returns float32 heatmaps;
    otherwise the graph computes in its parameters' dtype (float32 unless
    converted, e.g. ``model.double()`` for a float64 reference).
    """

    def __init__(self, backbone_name: str = "vgg", fold_bn: bool = False, width: float = 1.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.backbone_name = backbone_name
        self.width = width
        self.fold_bn = fold_bn
        self.dtype = dtype
        if backbone_name == "vgg":
            self.basenet = VGG16BN(width=width, fold_bn=fold_bn)
        elif "efficientnet" in backbone_name.lower():
            if fold_bn or width != 1.0:
                raise NotImplementedError(
                    "fold_bn/width are implemented for the VGG backbone only")
            self.basenet = EfficientNetBackbone(backbone_name, dtype)
        else:
            raise NotImplementedError(backbone_name)
        ch = self.basenet.channels
        c5 = _scaled(1024, width)
        self.slice5_1 = Conv2d(ch["s4"], c5, 3, padding="same", dilation=6)
        self.slice5_2 = Conv2d(c5, c5, 1)
        up = [_scaled(f, width) for f in (512, 256, 128, 64)]
        self.upconv1 = UpConv(c5 + ch["s4"], up[0], fold_bn)
        # cuDNN's float32 FFT pick (PerImageConv2d) hits this block's 3x3 conv.
        self.upconv2 = UpConv(up[0] // 2 + ch["s3"], up[1], fold_bn, per_image=True)
        self.upconv3 = UpConv(up[1] // 2 + ch["s2"], up[2], fold_bn)
        self.upconv4 = UpConv(up[2] // 2 + ch["s1"], up[3], fold_bn)
        self.conv_cls_0 = Conv2d(up[3] // 2, 32, 3, padding="same")
        self.conv_cls_2 = Conv2d(32, 32, 3, padding="same")
        self.conv_cls_4 = Conv2d(32, 16, 3, padding="same")
        self.conv_cls_6 = Conv2d(16, 16, 1)
        self.conv_cls_8 = Conv2d(16, 2, 1)

    @full_float32()
    def forward(self, x):
        if self.fold_bn:
            if self.training:
                raise ValueError("fold_bn=True is an inference-only graph")
            return self._forward_folded(x)
        # contiguous(): from a permuted NHWC tensor cuDNN runs every conv in
        # its channels-last fp32 kernels (CRAFT at batch 8 x 960x1280
        # measured 903 ms instead of 235 ms on an H100).
        x = x.to(self.compute_dtype).permute(0, 3, 1, 2).contiguous()
        s1, s2, s3, s4 = self.basenet(x)
        # The 3x3 max-pool reads a row each side, the dilated conv six.
        s5 = halo.apply(self._s5_head, s4, 7, dim=2)

        # Each decoder block's 3x3 conv reads a row each side.
        y = halo.apply(self.upconv1, torch.cat([s5, s4], 1), 1, dim=2)
        for block, skip in ((self.upconv2, s3), (self.upconv3, s2), (self.upconv4, s1)):
            y = halo.apply_upsampled(block, y, skip, 1, dims=(2, 3), channels=1)
        y = halo.apply(self._cls_head, y, 3, dim=2)
        if self.backbone_name != "vgg":
            y = sigmoid(y)
        return float32_output(y.permute(0, 2, 3, 1))

    def _s5_head(self, s4):
        """The s5 head on NCHW ``s4``: 3x3 stride-1 max-pool, the dilated
        conv, the 1x1 conv."""
        return self.slice5_2(self.slice5_1(F.max_pool2d(s4, 3, 1, padding=1)))

    def _cls_head(self, y):
        """The cls head on NCHW ``y`` up to the raw maps."""
        y = F.relu(self.conv_cls_0(y))
        y = F.relu(self.conv_cls_2(y))
        y = F.relu(self.conv_cls_4(y))
        y = F.relu(self.conv_cls_6(y))
        return self.conv_cls_8(y)

    @property
    def compute_dtype(self) -> torch.dtype:
        """bfloat16 where ``dtype`` asks for it, else the parameters'."""
        if self.dtype == torch.bfloat16:
            return self.dtype
        return self.slice5_1.weight.dtype

    def _forward_folded(self, x):
        """Inference graph with BatchNorm folded: NHWC throughout, 12 conv
        chains; the s5 head (a dilated conv neither kernel takes) stays
        cuDNN on a contiguous NCHW copy (in bfloat16 with Flax's two
        roundings, :class:`.layers.Conv2d`)."""
        x = x.to(self.compute_dtype).contiguous()
        s1, s2, s3, s4 = self.basenet.forward_folded(x)
        s5 = halo.apply(
            lambda t: self._s5_head(t.permute(0, 3, 1, 2).contiguous())
            .permute(0, 2, 3, 1).contiguous(), s4, 7)

        y = halo.apply(self.upconv1.forward_folded, torch.cat([s5, s4], -1), 1)
        for block, skip in ((self.upconv2, s3), (self.upconv3, s2), (self.upconv4, s1)):
            y = halo.apply_upsampled(block.forward_folded, y, skip, 1)
        head = [(self.conv_cls_0, True), (self.conv_cls_2, True), (self.conv_cls_4, True),
                (self.conv_cls_6, True), (self.conv_cls_8, False)]
        convs = [_chain_conv(conv, relu) for conv, relu in head]
        y = halo.apply(lambda t: conv_cuda.conv_chain(t, convs), y, 3)
        return float32_output(y)
