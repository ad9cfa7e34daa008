"""Ray marching helpers (port of part of ``nerf_texture_tpu/ops/marching.py``).

Only the ray/AABB slab test is ported so far; the occupancy march and
the sample pool belong to the training port."""

from __future__ import annotations

import torch


def near_far_from_aabb(rays_o: torch.Tensor, rays_d: torch.Tensor,
                       aabb: torch.Tensor, min_near: float = 0.2):
    """Ray/AABB slab test (raymarching.cu:94-147).

    rays_o, rays_d [..., 3]; aabb [6] (xmin, ymin, zmin, xmax, ymax, zmax).
    Returns (nears, fars) [...] with nears >= min_near; on a miss
    nears == fars == 0."""
    safe_d = torch.where(torch.abs(rays_d) > 1e-15, rays_d,
                         torch.where(rays_d >= 0, 1e-15, -1e-15))
    inv_d = 1.0 / safe_d
    t0 = (aabb[:3] - rays_o) * inv_d
    t1 = (aabb[3:] - rays_o) * inv_d
    near = torch.amax(torch.minimum(t0, t1), dim=-1)
    far = torch.amin(torch.maximum(t0, t1), dim=-1)
    hit = near <= far
    near = torch.clamp(near, min=min_near)
    hit = hit & (near <= far)
    near = torch.where(hit, near, 0.0)
    far = torch.where(hit, far, 0.0)
    return near, far
