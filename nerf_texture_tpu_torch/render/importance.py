"""Hierarchical importance-sampling renderer, the path without an
occupancy grid (port of ``nerf_texture_tpu/render/importance.py``).

The reference's ``NeRFRenderer.run`` (nerf/renderer.py:187-322): uniform
samples between near and far, inverse-CDF resampling from the coarse
weights (``sample_pdf``, renderer.py:16-50), the two sample sets merged
in order, and compositing.  For a field with no grid yet, or an offline
render of reference quality.

The JAX functions draw from a key; these take the draws as tensors:
``sample_pdf``'s quantiles ``u`` and ``render_rays_importance``'s
``jitter`` and ``u``.  Without them they take the deterministic
midpoints.
"""

from __future__ import annotations

import torch

from ..ops.composite import composite_rays
from ..ops.marching import near_far_from_aabb


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, n_samples: int,
               u: torch.Tensor | None = None) -> torch.Tensor:
    """Inverse-CDF sampling (renderer.py:16-50).

    bins [N, T] sorted sample positions; weights [N, T - 1]; u [N,
    n_samples] quantiles in [0, 1) (stratified uniforms), or None for the
    deterministic midpoints.  Returns [N, n_samples] positions."""
    weights = weights + 1e-5
    pdf = weights / torch.sum(weights, -1, keepdim=True)
    cdf = torch.cumsum(pdf, -1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], -1)
    if u is None:
        u = torch.linspace(0.5 / n_samples, 1.0 - 0.5 / n_samples,
                           n_samples, device=cdf.device, dtype=cdf.dtype)
        u = u.expand(*cdf.shape[:-1], n_samples)
    u = u.contiguous()
    inds = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=cdf.shape[-1] - 1)
    cdf_b = torch.gather(cdf, -1, below)
    cdf_a = torch.gather(cdf, -1, above)
    last = bins.shape[-1] - 1
    bins_b = torch.gather(bins, -1, torch.clamp(below, max=last))
    bins_a = torch.gather(bins, -1, torch.clamp(above, max=last))
    denom = torch.where(cdf_a - cdf_b < 1e-5, 1.0, cdf_a - cdf_b)
    t = (u - cdf_b) / denom
    return bins_b + t * (bins_a - bins_b)


def render_rays_importance(density_fn, field_fn, rays_o: torch.Tensor,
                           rays_d: torch.Tensor, *, num_steps: int = 128,
                           upsample_steps: int = 128, bound: float = 1.0,
                           min_near: float = 0.2,
                           density_scale: float = 1.0,
                           perturb: bool = False,
                           jitter: torch.Tensor | None = None,
                           u: torch.Tensor | None = None, bg_color=1.0):
    """Two-pass hierarchical rendering of rays [N, 3].

    density_fn: x [M, 3] -> sigma [M] (the coarse pass); field_fn: (x, d)
    -> (sigma, rgb) (the fine pass).  With ``perturb``, ``jitter`` [N,
    num_steps] in [0, 1) moves each uniform sample by (jitter - 0.5) of a
    step, and ``u`` [N, upsample_steps] are the quantiles of the
    resampling (``sample_pdf``); either left None keeps its deterministic
    default.  bg_color: scalar, [3] or [N, 3].

    Returns dict(image [N, 3], depth [N] in [0, 1], weights_sum [N],
    mask [N] (weights_sum > 0.95))."""
    N = rays_o.shape[0]
    aabb = torch.tensor([-bound] * 3 + [bound] * 3, dtype=rays_o.dtype,
                        device=rays_o.device)
    nears, fars = near_far_from_aabb(rays_o, rays_d, aabb, min_near)
    nears, fars = nears[:, None], fars[:, None]

    z = torch.linspace(0.0, 1.0, num_steps, device=rays_o.device,
                       dtype=rays_o.dtype)
    z_vals = nears + (fars - nears) * z[None, :]
    sample_dist = (fars - nears) / num_steps
    if perturb and jitter is not None:
        z_vals = z_vals + (jitter - 0.5) * sample_dist

    def pts(zv):
        p = rays_o[:, None, :] + rays_d[:, None, :] * zv[..., None]
        return torch.clamp(p, -bound, bound)

    if upsample_steps > 0:
        # the resampled positions carry no gradient (stop_gradient in the
        # JAX function), so neither does the coarse pass
        with torch.no_grad():
            sigmas = density_fn(pts(z_vals).reshape(-1, 3)).reshape(
                N, num_steps)
            deltas = torch.diff(z_vals, dim=-1)
            deltas = torch.cat([deltas, sample_dist.expand_as(
                deltas[..., :1])], -1)
            alphas = 1.0 - torch.exp(-deltas * density_scale * sigmas)
            shifted = torch.cat([torch.ones_like(alphas[..., :1]),
                                 1.0 - alphas + 1e-15], -1)
            weights = alphas * torch.cumprod(shifted, -1)[..., :-1]
            z_mid = z_vals[..., :-1] + 0.5 * deltas[..., :-1]
            new_z = sample_pdf(z_mid, weights[:, 1:-1], upsample_steps,
                               u=u if perturb else None)
        z_vals = torch.sort(torch.cat([z_vals, new_z], -1), -1).values

    T = z_vals.shape[-1]
    xyzs = pts(z_vals)
    dirs = rays_d[:, None, :].expand(xyzs.shape)
    sigmas, rgbs = field_fn(xyzs.reshape(-1, 3), dirs.reshape(-1, 3))
    sigmas = sigmas.reshape(N, T) * density_scale
    rgbs = rgbs.reshape(N, T, 3)
    deltas = torch.diff(z_vals, dim=-1)
    deltas = torch.cat([deltas, sample_dist.expand_as(deltas[..., :1])], -1)

    res = composite_rays(sigmas, rgbs, deltas, z_vals,
                         torch.ones_like(sigmas, dtype=torch.bool))
    bg = torch.as_tensor(bg_color, dtype=rays_o.dtype, device=rays_o.device)
    image = res.image + (1.0 - res.weights_sum)[..., None] * bg
    denom = torch.where(fars[:, 0] > nears[:, 0], fars[:, 0] - nears[:, 0],
                        1.0)
    ori = torch.clamp((res.depth - nears[:, 0]) / denom, 0.0, 1.0)
    return {"image": image, "depth": ori, "weights_sum": res.weights_sum,
            "mask": res.weights_sum > 0.95}
