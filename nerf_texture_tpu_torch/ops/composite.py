"""Volume-rendering compositor over fixed-width sample buffers (port of
``nerf_texture_tpu/ops/composite.py``).

Transmittance is an exclusive cumulative sum of sigma * dt,
T_i = exp(-sum_{j<i} sigma_j dt_j), so compositing is a few vectorised
ops whose autograd backward is exact; masked samples have sigma * dt = 0
and contribute nothing.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class CompositeResult(NamedTuple):
    image: torch.Tensor        # [N, C] accumulated colour (no background)
    depth: torch.Tensor        # [N] sum(w * t)
    weights_sum: torch.Tensor  # [N] opacity
    weights: torch.Tensor      # [N, K] per-sample weights


def composite_rays(sigmas, values, dts, ts, mask) -> CompositeResult:
    """Front-to-back alpha compositing of [N, K] samples: sigmas (already
    scaled by density_scale), values [N, K, C], dts, ts, mask (bool).
    ``depth`` is sum(w * t); the caller normalises it."""
    sdt = torch.where(mask, sigmas * dts, 0.0)
    alpha = 1.0 - torch.exp(-sdt)
    accum = torch.cumsum(sdt, dim=-1)
    trans = torch.exp(-(accum - sdt))                  # T_i
    weights = alpha * trans
    image = torch.einsum("nk,nkc->nc", weights, values)
    return CompositeResult(image=image,
                           depth=torch.sum(weights * ts, dim=-1),
                           weights_sum=torch.sum(weights, dim=-1),
                           weights=weights)


def composite_with_background(res: CompositeResult, bg_color):
    """image + (1 - weights_sum) * bg."""
    return res.image + (1.0 - res.weights_sum)[..., None] * bg_color
