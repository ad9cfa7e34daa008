"""2D grid sampling of a synthesised canvas (port of
``nerf_texture_tpu/utils/grid_sample.py``), written out as the JAX
function is rather than through ``F.grid_sample``: the canvas is [H, W, C]
channels-last, the corners align (align_corners=True) and the padding
is zero outside [-1, 1].
"""

from __future__ import annotations

import torch


def grid_sample_2d(image: torch.Tensor, coords: torch.Tensor, *,
                   mode: str = "bilinear",
                   padding_zero: bool = True) -> torch.Tensor:
    """Sample image [H, W, C] at coords [..., 2] in [-1, 1]:
    coords[..., 0] indexes W (x), coords[..., 1] indexes H (y).  'nearest'
    rounds half to even (as ``jnp.round``).  Returns [..., C]."""
    H, W = image.shape[:2]
    x = (coords[..., 0] + 1.0) * 0.5 * (W - 1)
    y = (coords[..., 1] + 1.0) * 0.5 * (H - 1)
    in_bounds = ((coords[..., 0] >= -1.0) & (coords[..., 0] <= 1.0)
                 & (coords[..., 1] >= -1.0) & (coords[..., 1] <= 1.0))
    if mode == "nearest":
        xi = torch.clamp(torch.round(x).to(torch.int64), 0, W - 1)
        yi = torch.clamp(torch.round(y).to(torch.int64), 0, H - 1)
        out = image[yi, xi]
    elif mode == "bilinear":
        x0 = torch.clamp(torch.floor(x).to(torch.int64), 0, W - 1)
        y0 = torch.clamp(torch.floor(y).to(torch.int64), 0, H - 1)
        x1 = torch.clamp(x0 + 1, 0, W - 1)
        y1 = torch.clamp(y0 + 1, 0, H - 1)
        fx = torch.clamp(x - x0, 0.0, 1.0)[..., None]
        fy = torch.clamp(y - y0, 0.0, 1.0)[..., None]
        out = ((1 - fx) * (1 - fy) * image[y0, x0]
               + fx * (1 - fy) * image[y0, x1]
               + (1 - fx) * fy * image[y1, x0]
               + fx * fy * image[y1, x1])
    else:
        raise ValueError(mode)
    if padding_zero:
        out = torch.where(in_bounds[..., None], out, 0.0)
    return out
