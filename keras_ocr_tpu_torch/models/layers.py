"""Layers the port's models share, and the float32 guard of their
forwards.

The layers compute in their input's dtype. Parameters stay float32 (Flax's
``param_dtype``); a bfloat16 input rounds where Flax's modules with
``dtype=jnp.bfloat16`` round:

- :class:`Conv2d` / :class:`Linear` (``nn.Conv`` / ``nn.Dense``): kernel
  and bias are cast to bf16, the conv or product writes bf16 (float32
  sums) and ``y += bias`` rounds a second time;
- :class:`BatchNorm2d` (``nn.BatchNorm``): the input is promoted to
  float32, the statistics (in training mode the batch's) and the affine
  stay float32, and the normalised result is rounded once to bf16;
- elementwise ops (ReLU, swish, sigmoid, products, sums) round after each
  op, as the JAX modules applied op by op do.

Training differentiates the same graph under autograd, as
``jax.value_and_grad`` differentiates the JAX modules: the transpose of a
cast is a cast back, so a bf16-rounded parameter gets a bf16 gradient that
reaches the float32 parameter as float32, and the gradient of a BatchNorm's
input is rounded to bf16 on each of its two paths (the normalisation and
the statistics) and summed there. :func:`sigmoid` and :func:`tanh` have
JAX's derivative rules.

That is the rounding of the JAX modules run op by op (``model.apply``);
a jitted program fuses some elementwise chains and skips their inner
roundings. Either way a bf16 result also depends on the order of each
float32 sum, which no port reproduces: two conv algorithms that sum in
another order round some values to the neighbouring bf16 number, and the
network amplifies those flips (PERF.md §6).
"""

from __future__ import annotations

import contextlib
import threading

import torch
from torch import nn
from torch.nn import functional as F

from ..parallel import replicas


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` that takes a bfloat16 input with float32 parameters as
    Flax's ``nn.Conv(dtype=jnp.bfloat16)`` does: the conv of the input and
    the bf16-rounded kernel writes bf16, then the bf16 bias is added (a
    second rounding). Inputs of the parameters' dtype run as
    ``nn.Conv2d``."""

    def _conv_forward(self, x, weight, bias):
        if x.dtype == weight.dtype:
            return super()._conv_forward(x, weight, bias)
        y = super()._conv_forward(x, weight.to(x.dtype), None)
        return y if bias is None else y + bias.to(x.dtype).reshape(-1, 1, 1)


def linear(x, weight, bias=None):
    """``F.linear`` with :class:`Conv2d`'s rule for a bfloat16 input to
    float32 parameters (Flax's ``nn.Dense(dtype=jnp.bfloat16)``): the
    product with the bf16-rounded weight writes bf16, then the bf16 bias is
    added."""
    if x.dtype == weight.dtype:
        return F.linear(x, weight, bias)
    y = F.linear(x, weight.to(x.dtype))
    return y if bias is None else y + bias.to(x.dtype)


class Linear(nn.Linear):
    """``nn.Linear`` that takes a bfloat16 input as :func:`linear` does."""

    def forward(self, x):
        return linear(x, self.weight, self.bias)


def float32_output(y):
    """A model's output: float32 from a bfloat16 graph, as the JAX modules
    return ``y.astype(jnp.float32)``; other dtypes as they are."""
    return y.float() if y.dtype == torch.bfloat16 else y


class _Bf16Sigmoid(torch.autograd.Function):
    """``1 / (1 + exp(-x))`` rounded after each op, with JAX's derivative
    rule for ``lax.logistic``: ``g * (y * (1 - y))``, also rounded after
    each op."""

    @staticmethod
    def forward(ctx, x):
        y = 1.0 / (1.0 + torch.exp(-x))
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, grad):
        (y,) = ctx.saved_tensors
        return grad * (y * (1.0 - y))


def sigmoid(x):
    """``torch.sigmoid``; a bfloat16 input takes ``1 / (1 + exp(-x))`` with
    a rounding after each op, as XLA expands the JAX package's
    ``jax.nn.sigmoid`` on a bf16 input, and differentiates as JAX does."""
    if x.dtype == torch.bfloat16:
        return _Bf16Sigmoid.apply(x)
    return torch.sigmoid(x)


class _Bf16Tanh(torch.autograd.Function):
    """``torch.tanh`` with JAX's derivative rule for ``lax.tanh``:
    ``(g + g * y) * (1 - y)``, rounded after each op."""

    @staticmethod
    def forward(ctx, x):
        y = torch.tanh(x)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, grad):
        (y,) = ctx.saved_tensors
        return (grad + grad * y) * (1.0 - y)


def tanh(x):
    """``torch.tanh``; a bfloat16 input differentiates as JAX does."""
    if x.dtype == torch.bfloat16:
        return _Bf16Tanh.apply(x)
    return torch.tanh(x)


def swish(x):
    """``x * sigmoid(x)``: ``F.silu``, except that a bfloat16 input rounds
    the sigmoid (:func:`sigmoid`) and the product, as Flax's ``nn.swish``
    does."""
    if x.dtype == torch.bfloat16:
        return x * sigmoid(x)
    return F.silu(x)


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` that keeps its running statistics as Flax does.

    In training mode a batch is normalised with its own mean and biased
    variance, as in torch; the running variance is then updated with that
    *biased* variance (torch uses the unbiased one, n / (n - 1) larger):
    ``running = (1 - momentum) * running + momentum * batch``. Flax's
    ``momentum`` is ``1 - momentum`` here. Evaluation mode is torch's.
    A bfloat16 input to float32 parameters is promoted to float32, its
    statistics are taken and it is normalised there, and the result is
    rounded once to bf16, as Flax's ``nn.BatchNorm(dtype=jnp.bfloat16)``
    does (``_compute_stats`` and ``_normalize``), in both modes: the running
    statistics stay float32.
    ``updates_per_call`` folds one batch's statistics in that many times,
    for a Flax module that the JAX model calls more than once on the same
    input (:class:`.efficientnet.MBConv`).

    In a replica forward of a mesh trainer (:func:`..parallel.replicas.current`)
    the statistics are the whole batch's, over every replica's shard (every
    process's, on a mesh across processes), as Flax's are under ``jit`` on
    a batch-sharded array; the same arithmetic with cross-replica sums, and
    each process's rank 0 alone updates its running statistics.
    """

    updates_per_call = 1

    def forward(self, x):
        if not self.training:
            return super().forward(x.to(self.weight.dtype)).to(x.dtype)
        replica = replicas.current()
        if replica is None and x.dtype == self.weight.dtype:
            with torch.no_grad():
                var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
                self._update_running(mean, var)
            return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)
        # Flax's graph: the statistics of one float32 copy of x normalise
        # another, so that backward rounds each path's gradient to x's dtype
        # on its own and adds the two there, as JAX transposes the two casts
        # of ``_compute_stats`` and ``_normalize``.
        dtype = self.weight.dtype
        if replica is None:
            var, mean = torch.var_mean(x.to(dtype), dim=(0, 2, 3), unbiased=False)
            with torch.no_grad():
                self._update_running(mean, var)
        else:
            group, rank = replica
            mean, var = group.batch_moments(rank, x.to(dtype))
            if rank == 0:
                with torch.no_grad():
                    self._update_running(mean.to(self.running_mean.device),
                                         var.to(self.running_var.device))
        shape = (1, -1, 1, 1)
        scale = torch.rsqrt(var + self.eps) * self.weight
        y = (x.to(dtype) - mean.reshape(shape)) * scale.reshape(shape) + self.bias.reshape(shape)
        return y.to(x.dtype)

    def _update_running(self, mean, var):
        keep = 1.0 - self.momentum
        for _ in range(self.updates_per_call):
            self.running_mean.mul_(keep).add_(mean, alpha=self.momentum)
            self.running_var.mul_(keep).add_(var, alpha=self.momentum)
        self.num_batches_tracked += 1


# full_float32's nesting depth across threads, and the flags it restores
# when the outermost block ends: the flags are process-wide, so a thread
# that leaves while another is inside must not turn TF32 back on.
_FLOAT32_LOCK = threading.Lock()
_float32_depth = 0
_float32_saved = None


@contextlib.contextmanager
def full_float32():
    """Run the block in full float32 whatever the process-wide flags say:
    TF32 off for cuDNN (convolutions and RNNs) and for cuBLAS matmuls, the
    caller's settings restored when the outermost such block (of any
    thread) ends. PyTorch lets cuDNN convolutions use TF32 by default,
    which moves the full-width VGG16-BN CRAFT's heatmaps 3.2e-4 from
    float32 on an H100, past the port's 1e-4 parity bar. Also a decorator
    (``@full_float32()``)."""
    global _float32_depth, _float32_saved
    with _FLOAT32_LOCK:
        if _float32_depth == 0:
            _float32_saved = (torch.backends.cudnn.allow_tf32,
                              torch.get_float32_matmul_precision())
            torch.backends.cudnn.allow_tf32 = False
            torch.set_float32_matmul_precision("highest")
        _float32_depth += 1
    try:
        yield
    finally:
        with _FLOAT32_LOCK:
            _float32_depth -= 1
            if _float32_depth == 0:
                torch.backends.cudnn.allow_tf32 = _float32_saved[0]
                torch.set_float32_matmul_precision(_float32_saved[1])
