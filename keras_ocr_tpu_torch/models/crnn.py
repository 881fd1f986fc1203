"""CRNN text recognizer as a PyTorch module.

Port of ``keras_ocr_tpu/models/crnn.py``, with the reference semantics it
reproduces:

* the (H=31, W=200, C) NHWC input is permuted to width-major and flipped
  along the original height axis, so the conv stack sees a (200, 31) image;
* seven 3x3 convs with ReLU, BatchNorm (eps 1e-3) after convs 3, 5 and 7,
  2x2 max-pools after bn_3 and bn_5;
* the affine spatial transformer samples with indices clipped BEFORE the
  bilinear weights, so taps past the right/bottom edge contribute zero, and
  starts from the identity (zero kernel, identity bias);
* the (B, 50, 7, C) features flatten per frame in (w, c) order, as NHWC;
* two bidirectional LSTM stages (Keras gate order [i, f, c~, o], which is
  PyTorch's [i, f, g, o]) whose backward output stays in processing order,
  i.e. NOT re-reversed: stage 1 sums the directions, stage 2 concatenates;
* dropout on the biLSTM features in training mode, then a softmax over
  ``alphabet_size + 1`` classes with the first ``rnn_steps_to_discard``
  frames dropped.

Training mode (``model.train()``) is the JAX module's ``train=True``: the
three BatchNorms normalise with batch statistics and update their running
ones with Flax's momentum 0.99 (torch momentum 0.01) and biased variance
(:class:`.layers.BatchNorm2d`), and the dropout mask is drawn from the
``torch.Generator`` passed to ``forward``. The LSTMs' ``bias_hh`` stay zero
and frozen: the Keras layer has one bias, carried in ``bias_ih``, and a
trained second copy would move the sum twice as far.
"""

from __future__ import annotations

import typing

import torch
from torch import nn
from torch.nn import functional as F

from ..parallel.replicas import column_parallel
from .layers import (BatchNorm2d, Conv2d, Linear, float32_output, full_float32, linear,
                     sigmoid, tanh)

DEFAULT_BUILD_PARAMS = {
    "height": 31,
    "width": 200,
    "color": False,
    "filters": (64, 128, 256, 256, 512, 512, 512),
    "rnn_units": (128, 128),
    "dropout": 0.25,
    "rnn_steps_to_discard": 2,
    "pool_size": 2,
    "stn": True,
}


def bilstm_steps(lstm, x, devices=None):
    """A bidirectional ``nn.LSTM`` layer walked step by step as the JAX
    package's ``fused_bilstm`` computes it: the weights cast to ``x``'s
    dtype, the input projections and their bias, then per step
    ``z = z_t + h @ R`` and the gates, ``h`` and ``c`` carried in that dtype
    (in bfloat16 each gate, ``c`` and ``h`` rounded after every op, the
    sigmoid :func:`.layers.sigmoid`). Returns the forward and the backward
    outputs, the backward one in processing order (Keras's
    ``go_backwards``).

    In bfloat16 it is the reference the tests hold the CRNN's ``nn.LSTM``
    path to. With ``devices`` (tensor parallelism) the gate columns of both
    products are split into ``len(devices)`` contiguous blocks, block ``k``
    computed on ``devices[k]`` and gathered on ``x``'s device each step."""
    units, dtype = lstm.hidden_size, x.dtype
    devices = devices or [x.device]

    def stream(suffix, inputs, block, device):
        def part(name):
            return getattr(lstm, f"{name}_l0{suffix}").chunk(len(devices))[block].to(device, dtype)

        return F.linear(inputs.to(device), part("weight_ih")) + part("bias_ih"), part("weight_hh").T

    proj, recurrent = [], []
    for block, device in enumerate(devices):
        proj_f, rec_f = stream("", x, block, device)
        proj_b, rec_b = stream("_reverse", x.flip(1), block, device)
        proj.append(torch.stack([proj_f, proj_b]))  # (2, B, T, 4u / blocks)
        recurrent.append(torch.stack([rec_f, rec_b]))  # (2, u, 4u / blocks)
    h = c = x.new_zeros((2, x.shape[0], units))
    outputs = []
    for t in range(x.shape[1]):
        z = torch.cat([(p[:, :, t] + torch.bmm(h.to(device), r)).to(x.device)
                       for p, r, device in zip(proj, recurrent, devices)], -1)
        i, f, g, o = z.split(units, -1)
        c = sigmoid(f) * c + sigmoid(i) * tanh(g)
        h = sigmoid(o) * tanh(c)
        outputs.append(h)
    out = torch.stack(outputs, 2)  # (2, B, T, u)
    return out[0], out[1]


class SpatialTransformer(nn.Module):
    """Affine STN with the reference's grid and sampling arithmetic, on
    NHWC features."""

    def __init__(self, channels: int, height: int, width: int):
        super().__init__()
        self.conv1 = Conv2d(channels, 16, 5, padding="same")
        self.conv2 = Conv2d(16, 32, 5, padding="same")
        self.dense1 = Linear(height * width * 32, 64)
        self.dense2 = Linear(64, 6)

    def forward(self, x):
        batch, height, width, channels = x.shape
        y = F.relu(self.conv1(x.permute(0, 3, 1, 2).contiguous()))
        y = F.relu(self.conv2(y))
        y = y.permute(0, 2, 3, 1).reshape(batch, -1)  # flatten in (h, w, c)
        y = F.relu(self.dense1(y))
        theta = self.dense2(y).reshape(batch, 2, 3)
        # A bfloat16 net samples in float32 (the JAX module's theta and its
        # HIGHEST-precision sampling) and rounds the result once.
        if theta.dtype == torch.bfloat16:
            theta = theta.float()
        dtype = theta.dtype

        def linspace(n):
            grid = torch.linspace(-1.0, 1.0, n, dtype=torch.float64, device=x.device)
            return grid.to(dtype)

        gx = linspace(width)[None, :].expand(height, width).reshape(1, -1)
        gy = linspace(height)[:, None].expand(height, width).reshape(1, -1)
        t = theta[:, :, :, None]
        tx = t[:, 0, 0] * gx + t[:, 0, 1] * gy + t[:, 0, 2]
        ty = t[:, 1, 0] * gx + t[:, 1, 1] * gy + t[:, 1, 2]
        sx = 0.5 * (tx + 1.0) * width
        sy = 0.5 * (ty + 1.0) * height

        x0 = torch.floor(sx).to(torch.int64)
        y0 = torch.floor(sy).to(torch.int64)
        x0c = x0.clamp(0, width - 1)
        x1c = (x0 + 1).clamp(0, width - 1)
        y0c = y0.clamp(0, height - 1)
        y1c = (y0 + 1).clamp(0, height - 1)
        # Weights from the CLIPPED indices: where both taps clip to the same
        # edge pixel they cancel, the reference's zero edge contribution.
        wx_lo = (x1c.to(dtype) - sx)[..., None]
        wx_hi = (sx - x0c.to(dtype))[..., None]
        wy_lo = (y1c.to(dtype) - sy)[..., None]
        wy_hi = (sy - y0c.to(dtype))[..., None]

        feats = x.reshape(batch, height * width, channels).to(dtype)

        def tap(yy, xx):
            index = (yy * width + xx)[..., None].expand(-1, -1, channels)
            return torch.gather(feats, 1, index)

        left = wy_lo * tap(y0c, x0c) + wy_hi * tap(y1c, x0c)
        right = wy_lo * tap(y0c, x1c) + wy_hi * tap(y1c, x1c)
        out = wx_lo * left + wx_hi * right
        return out.reshape(batch, height, width, channels).to(x.dtype)


class CRNN(nn.Module):
    """Full CRNN graph: (B, H, W, C) crops in [0, 1] -> (B, T, classes)
    softmax frames, the first ``rnn_steps_to_discard`` dropped (``forward``
    says what else it returns). ``dtype`` is the JAX module's:
    ``torch.bfloat16`` computes in bfloat16 with float32 parameters
    (:mod:`.layers`; the STN samples in float32; the LSTMs are ``nn.LSTM``
    on bf16 weights) and returns float32 frames; otherwise the graph
    computes in its parameters' dtype.

    ``tensor_parallel`` maps a layer (the module ``fc_9``, ``fc_12``,
    ``lstm_10`` or ``lstm_11``) to the devices its kernel's columns are
    split over: the replicas of a tensor-parallel trainer set it
    (:class:`..train.RecognizerTrainer`); empty, every layer runs whole."""

    def __init__(
        self,
        alphabet_size: int = 36,
        height: int = 31,
        width: int = 200,
        color: bool = False,
        filters: typing.Sequence[int] = (64, 128, 256, 256, 512, 512, 512),
        rnn_units: typing.Sequence[int] = (128, 128),
        dropout: float = 0.25,
        rnn_steps_to_discard: int = 2,
        pool_size: int = 2,
        stn: bool = True,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.dtype = dtype
        if len(filters) != 7:
            raise ValueError("7 CNN filters must be provided.")
        if len(rnn_units) != 2:
            raise ValueError("2 RNN filters must be provided.")
        self.height, self.width = height, width
        self.pool_size = pool_size
        self.rnn_steps_to_discard = rnn_steps_to_discard
        self.dropout = dropout
        self.tensor_parallel: typing.Dict[nn.Module, list] = {}
        in_ch = 3 if color else 1
        for i, out_ch in enumerate(filters, start=1):
            self.add_module(f"conv_{i}", Conv2d(in_ch, out_ch, 3, padding="same"))
            in_ch = out_ch
        # Flax momentum 0.99 = torch momentum 0.01.
        self.bn_3 = BatchNorm2d(filters[2], eps=1e-3, momentum=0.01)
        self.bn_5 = BatchNorm2d(filters[4], eps=1e-3, momentum=0.01)
        self.bn_7 = BatchNorm2d(filters[6], eps=1e-3, momentum=0.01)
        steps = width // pool_size**2
        rows = height // pool_size**2
        self.stn = SpatialTransformer(filters[6], steps, rows) if stn else None
        u1, u2 = rnn_units
        self.fc_9 = Linear(rows * filters[6], u1)
        self.lstm_10 = nn.LSTM(u1, u1, batch_first=True, bidirectional=True)
        self.lstm_11 = nn.LSTM(u1, u2, batch_first=True, bidirectional=True)
        self.fc_12 = Linear(2 * u2, alphabet_size + 1)
        for lstm in (self.lstm_10, self.lstm_11):
            for name, param in lstm.named_parameters():
                if name.startswith("bias_hh"):
                    param.requires_grad_(False)

    @property
    def compute_dtype(self) -> torch.dtype:
        """bfloat16 where ``dtype`` asks for it, else the parameters'."""
        if self.dtype == torch.bfloat16:
            return self.dtype
        return self.fc_9.weight.dtype

    def _dense(self, layer, x):
        devices = self.tensor_parallel.get(layer)
        if devices is None:
            return layer(x)
        return column_parallel(linear, x, layer.weight, layer.bias, devices)

    def _bilstm(self, lstm, x):
        devices = self.tensor_parallel.get(lstm)
        if devices is not None:
            return bilstm_steps(lstm, x, devices)
        if x.dtype != lstm.weight_ih_l0.dtype:
            # bfloat16: the layer with its float32 weights cast to bf16. On
            # the card cuDNN keeps the cell arithmetic in float32 and rounds
            # what it writes, in training its backward too; bilstm_steps is
            # the JAX package's rounding.
            bf16 = {name: p.to(x.dtype) for name, p in lstm.named_parameters()}
            out, _ = torch.func.functional_call(lstm, bf16, (x,))
        else:
            out, _ = lstm(x)
        units = lstm.hidden_size
        # PyTorch aligns the backward stream with input time; Keras's
        # go_backwards output stays in processing order.
        return out[..., :units], out[..., units:].flip(1)

    @full_float32()
    def forward(self, x, return_logits=False, return_backbone=False, generator=None):
        """(B, H, W, C) crops -> softmax frames (B, T, classes).

        ``return_logits``: the pre-softmax frames instead.
        ``return_backbone``: the (B, T + discarded, 2 * units) biLSTM
        features before the dropout (no frame dropped).
        ``generator``: the ``torch.Generator`` (on ``x``'s device) of the
        training-mode dropout mask; training mode with dropout needs one.
        """
        # NHWC (B, H, W, C) -> NCHW (B, C, W, H), flipped along H.
        x = x.to(self.compute_dtype).permute(0, 3, 2, 1).flip(3).contiguous()
        p = self.pool_size
        x = F.relu(self.conv_1(x))
        x = F.relu(self.conv_2(x))
        x = F.relu(self.conv_3(x))
        x = F.max_pool2d(self.bn_3(x), p, p)
        x = F.relu(self.conv_4(x))
        x = F.relu(self.conv_5(x))
        x = F.max_pool2d(self.bn_5(x), p, p)
        x = F.relu(self.conv_6(x))
        x = F.relu(self.conv_7(x))
        x = self.bn_7(x).permute(0, 2, 3, 1)  # NHWC (B, steps, rows, C)
        if self.stn is not None:
            x = self.stn(x)
        x = x.reshape(x.shape[0], x.shape[1], -1)
        x = F.relu(self._dense(self.fc_9, x))
        fwd, bwd = self._bilstm(self.lstm_10, x)
        fwd, bwd = self._bilstm(self.lstm_11, fwd + bwd)
        features = torch.cat([fwd, bwd], -1)
        if return_backbone:
            return float32_output(features)
        # The logits are float32 from a bfloat16 graph, as in the JAX
        # module, and so is the softmax.
        x = float32_output(self._dense(self.fc_12, self._dropout(features, generator)))
        if not return_logits:
            x = torch.softmax(x, -1)
        return x[:, self.rnn_steps_to_discard :]

    def _dropout(self, x, generator):
        """Flax's dropout: keep with probability 1 - p, survivors scaled by
        1 / (1 - p); the identity in evaluation mode."""
        if not self.training or self.dropout == 0.0:
            return x
        if generator is None:
            raise ValueError("training-mode dropout draws its mask from a torch.Generator; "
                             "pass generator=")
        keep = 1.0 - self.dropout
        mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
        return torch.where(mask, x / keep, 0.0)
