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

from .layers import BatchNorm2d

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


class SpatialTransformer(nn.Module):
    """Affine STN with the reference's grid and sampling arithmetic, on
    NHWC features."""

    def __init__(self, channels: int, height: int, width: int):
        super().__init__()
        self.conv1 = nn.Conv2d(channels, 16, 5, padding="same")
        self.conv2 = nn.Conv2d(16, 32, 5, padding="same")
        self.dense1 = nn.Linear(height * width * 32, 64)
        self.dense2 = nn.Linear(64, 6)

    def forward(self, x):
        batch, height, width, channels = x.shape
        y = F.relu(self.conv1(x.permute(0, 3, 1, 2).contiguous()))
        y = F.relu(self.conv2(y))
        y = y.permute(0, 2, 3, 1).reshape(batch, -1)  # flatten in (h, w, c)
        y = F.relu(self.dense1(y))
        theta = self.dense2(y).reshape(batch, 2, 3)
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

        feats = x.reshape(batch, height * width, channels)

        def tap(yy, xx):
            index = (yy * width + xx)[..., None].expand(-1, -1, channels)
            return torch.gather(feats, 1, index)

        left = wy_lo * tap(y0c, x0c) + wy_hi * tap(y1c, x0c)
        right = wy_lo * tap(y0c, x1c) + wy_hi * tap(y1c, x1c)
        out = wx_lo * left + wx_hi * right
        return out.reshape(batch, height, width, channels)


class CRNN(nn.Module):
    """Full CRNN graph: (B, H, W, C) crops in [0, 1] -> (B, T, classes)
    softmax frames, the first ``rnn_steps_to_discard`` dropped (``forward``
    says what else it returns)."""

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
    ):
        super().__init__()
        if len(filters) != 7:
            raise ValueError("7 CNN filters must be provided.")
        if len(rnn_units) != 2:
            raise ValueError("2 RNN filters must be provided.")
        self.height, self.width = height, width
        self.pool_size = pool_size
        self.rnn_steps_to_discard = rnn_steps_to_discard
        self.dropout = dropout
        in_ch = 3 if color else 1
        for i, out_ch in enumerate(filters, start=1):
            self.add_module(f"conv_{i}", nn.Conv2d(in_ch, out_ch, 3, padding="same"))
            in_ch = out_ch
        # Flax momentum 0.99 = torch momentum 0.01.
        self.bn_3 = BatchNorm2d(filters[2], eps=1e-3, momentum=0.01)
        self.bn_5 = BatchNorm2d(filters[4], eps=1e-3, momentum=0.01)
        self.bn_7 = BatchNorm2d(filters[6], eps=1e-3, momentum=0.01)
        steps = width // pool_size**2
        rows = height // pool_size**2
        self.stn = SpatialTransformer(filters[6], steps, rows) if stn else None
        u1, u2 = rnn_units
        self.fc_9 = nn.Linear(rows * filters[6], u1)
        self.lstm_10 = nn.LSTM(u1, u1, batch_first=True, bidirectional=True)
        self.lstm_11 = nn.LSTM(u1, u2, batch_first=True, bidirectional=True)
        self.fc_12 = nn.Linear(2 * u2, alphabet_size + 1)
        for lstm in (self.lstm_10, self.lstm_11):
            for name, param in lstm.named_parameters():
                if name.startswith("bias_hh"):
                    param.requires_grad_(False)

    def _bilstm(self, lstm, x):
        out, _ = lstm(x)
        units = lstm.hidden_size
        # PyTorch aligns the backward stream with input time; Keras's
        # go_backwards output stays in processing order.
        return out[..., :units], out[..., units:].flip(1)

    def forward(self, x, return_logits=False, return_backbone=False, generator=None):
        """(B, H, W, C) crops -> softmax frames (B, T, classes).

        ``return_logits``: the pre-softmax frames instead.
        ``return_backbone``: the (B, T + discarded, 2 * units) biLSTM
        features before the dropout (no frame dropped).
        ``generator``: the ``torch.Generator`` (on ``x``'s device) of the
        training-mode dropout mask; training mode with dropout needs one.
        """
        # NHWC (B, H, W, C) -> NCHW (B, C, W, H), flipped along H.
        # The graph computes in its parameters' dtype (float32 unless converted).
        x = x.to(self.fc_9.weight.dtype).permute(0, 3, 2, 1).flip(3).contiguous()
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
        x = F.relu(self.fc_9(x))
        fwd, bwd = self._bilstm(self.lstm_10, x)
        fwd, bwd = self._bilstm(self.lstm_11, fwd + bwd)
        features = torch.cat([fwd, bwd], -1)
        if return_backbone:
            return features
        x = self.fc_12(self._dropout(features, generator))
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
