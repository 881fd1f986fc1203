"""Optimisers with the JAX package's (optax's) update rules.

``RMSprop`` is ``optax.rmsprop(lr)``, the recognizer's default, which
``torch.optim.RMSprop`` cannot express (its decay defaults to 0.99 and its
eps sits outside the square root). ``adam`` is ``optax.adam(lr)``, the
detector's default: ``torch.optim.Adam`` with optax's betas and eps
computes the same bias-corrected rule.
"""

from __future__ import annotations

import torch


class RMSprop(torch.optim.Optimizer):
    """optax's RMSprop: ``nu = decay * nu + (1 - decay) * g**2``, then
    ``p -= lr * g * rsqrt(nu + eps)`` with eps inside the root; no
    centring, momentum or bias correction; ``nu`` starts at 0."""

    def __init__(self, params, lr: float = 1e-3, decay: float = 0.9, eps: float = 1e-8):
        super().__init__(params, {"lr": lr, "decay": decay, "eps": eps})

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            decay, eps, lr = group["decay"], group["eps"], group["lr"]
            for param in group["params"]:
                if param.grad is None:
                    continue
                grad = param.grad
                state = self.state[param]
                if not state:
                    state["nu"] = torch.zeros_like(param)
                nu = state["nu"]
                nu.mul_(decay).addcmul_(grad, grad, value=1.0 - decay)
                param.add_(grad * torch.rsqrt(nu + eps), alpha=-lr)
        return loss


def adam(params, lr: float = 1e-3) -> torch.optim.Optimizer:
    """``optax.adam(lr)``: betas (0.9, 0.999), eps 1e-8 outside the root."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
