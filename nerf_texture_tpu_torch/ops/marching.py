"""Occupancy-grid ray marching (port of ``nerf_texture_tpu/ops/marching.py``).

The march advances t by a fixed step whether a cell is occupied or not;
occupancy only decides which samples are emitted.  So it is three
vectorised phases: the t-sequence per ray [N, S], one occupancy gather
[N, S], and a stable per-row compaction of the kept samples into K slots.

Only the constant step (``dt_gamma == 0``, the bench setting) is ported;
the per-step scan of ``dt_gamma > 0`` raises.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

SQRT3 = math.sqrt(3.0)


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


class MarchResult(NamedTuple):
    ts: torch.Tensor      # [N, K] sample distances (0 where invalid)
    dts: torch.Tensor     # [N, K] integration step sizes
    mask: torch.Tensor    # [N, K] bool sample validity
    counts: torch.Tensor  # [N] int64 valid samples per ray


def _t_sequence(t0, *, dt_gamma: float, dt_min: float, num_steps: int):
    """(ts, dts) [N, S] of the advance t += dt_min (dt_gamma == 0)."""
    if dt_gamma != 0.0:
        raise NotImplementedError(
            "march_rays: dt_gamma > 0 (the per-step scan) is not ported; "
            "ROADMAP Queue 1, item 4")
    steps = torch.arange(num_steps, dtype=t0.dtype, device=t0.device)
    ts = t0[:, None] + steps[None, :] * dt_min
    return ts, torch.full_like(ts, dt_min)


def march_rays(rays_o, rays_d, occ, nears, fars, *, bound: float,
               cascades: int, grid_size: int, max_steps: int = 1024,
               max_samples: int = 256, dt_gamma: float = 0.0,
               perturb: bool = False, u=None,
               dt_steps: int | None = None) -> MarchResult:
    """March [N] rays through a [cascades * H^3] uint8 occupancy grid into
    [N, max_samples] sample buffers.

    ``perturb`` shifts each ray's start by dt_min * u with the jitter u
    [N] in [0, 1), which the caller draws (the JAX function draws it from
    its key)."""
    if cascades != 1:
        raise NotImplementedError(
            "march_rays: cascades > 1 (bound > 1) is not ported; ROADMAP "
            "Queue 1, item 4")
    N = rays_o.shape[0]
    H = grid_size
    dt_min = 2.0 * SQRT3 / (dt_steps or max_steps)
    t0 = nears
    if perturb:
        if u is None:
            raise ValueError("march_rays: perturb=True needs the jitter u")
        t0 = t0 + dt_min * u
    ts, dts = _t_sequence(t0, dt_gamma=dt_gamma, dt_min=dt_min,
                          num_steps=max_steps)                 # [N, S]

    def cell(ax):
        # truncation toward zero, as the JAX .astype(int32)
        p = torch.clamp(rays_o[:, ax:ax + 1] + ts * rays_d[:, ax:ax + 1],
                        -bound, bound)
        c = ((p + bound) * (H / (2.0 * bound))).to(torch.int32)
        return torch.clamp(c, 0, H - 1).to(torch.int64)

    flat = (cell(0) * H + cell(1)) * H + cell(2)
    occupied = occ[flat.reshape(-1)].reshape(N, max_steps) > 0
    keep = occupied & (ts < fars[:, None])                       # [N, S]

    total = torch.sum(keep.to(torch.int64), dim=-1)
    counts = torch.clamp(total, max=max_samples)
    k_eff = min(max_samples, max_steps)
    src = torch.argsort((~keep).to(torch.uint8), dim=-1,
                        stable=True)[:, :k_eff]
    valid = (torch.arange(max_samples, device=rays_o.device)[None, :]
             < counts[:, None])
    ts_c = t0[:, None] + src.to(ts.dtype) * dt_min
    dts_c = torch.full_like(ts_c, dt_min)
    if k_eff < max_samples:
        ts_c = torch.nn.functional.pad(ts_c, (0, max_samples - k_eff))
        dts_c = torch.nn.functional.pad(dts_c, (0, max_samples - k_eff))
    return MarchResult(ts=ts_c * valid, dts=dts_c * valid, mask=valid,
                       counts=counts)


def sample_points(rays_o, rays_d, result: MarchResult, bound: float):
    """[N, K, 3] sample positions (clamped to the AABB) and directions."""
    pos = torch.clamp(rays_o[:, None, :] + result.ts[..., None]
                      * rays_d[:, None, :], -bound, bound)
    return pos, rays_d[:, None, :].expand(pos.shape)
