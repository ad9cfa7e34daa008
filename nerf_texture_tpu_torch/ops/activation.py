"""Activation functions (port of ``nerf_texture_tpu/ops/activation.py``)."""

from __future__ import annotations

import torch


class _TruncExp(torch.autograd.Function):
    """exp(clamp(x, -15, 15)) with the exact VJP of the clamped forward:
    zero gradient beyond the saturation point, so saturated cells stop
    accumulating (the JAX module's docstring has the history)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.exp(torch.clamp(x, -15.0, 15.0))

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        grad = torch.where(torch.abs(x) < 15.0,
                           torch.exp(torch.clamp(x, -15.0, 15.0)), 0.0)
        return g * grad


def trunc_exp(x: torch.Tensor) -> torch.Tensor:
    """The truncated density activation: exp(clamp(x, -15, 15))."""
    return _TruncExp.apply(x)


def biased_softplus(x: torch.Tensor, bias: float = 0.0) -> torch.Tensor:
    """Softplus with a shift, an alternative density activation:
    log(1 + exp(x + bias)) (torch's, linear beyond 20)."""
    return torch.nn.functional.softplus(x + bias)
