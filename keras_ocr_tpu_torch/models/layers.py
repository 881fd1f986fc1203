"""Layers the port's models share."""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` that keeps its running statistics as Flax does.

    In training mode a batch is normalised with its own mean and biased
    variance, as in torch; the running variance is then updated with that
    *biased* variance (torch uses the unbiased one, n / (n - 1) larger):
    ``running = (1 - momentum) * running + momentum * batch``. Flax's
    ``momentum`` is ``1 - momentum`` here. Evaluation mode is torch's.
    """

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
            keep = 1.0 - self.momentum
            self.running_mean.mul_(keep).add_(mean, alpha=self.momentum)
            self.running_var.mul_(keep).add_(var, alpha=self.momentum)
            self.num_batches_tracked += 1
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)
