"""Occupancy-grid ray marching (port of ``nerf_texture_tpu/ops/marching.py``).

The march advances t whether a cell is occupied or not; occupancy only
decides which samples are emitted.  So it is three vectorised phases: the
t-sequence per ray [N, S], one occupancy gather [N, S], and a stable
per-row compaction of the kept samples into K slots.

The step is constant (``dt_gamma == 0``, closed form) or grows with t,
t += clamp(t * dt_gamma, dt_min, dt_max): a sequential loop of S steps
over all rays at once, in the JAX scan's order, so the t values are the
same f32 numbers.  A grid of several cascades (``bound`` > 1) looks each
sample up in the level that holds both its position and its step
(``frexp`` of the largest coordinate and of the step in cells).
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


def polar_from_ray(rays_o: torch.Tensor, rays_d: torch.Tensor,
                   radius: float) -> torch.Tensor:
    """Normalised (theta, phi) in [-1, 1] of each ray's far intersection
    with the background sphere of ``radius`` (kernel_polar_from_ray,
    raymarching.cu:165-200; y up).  rays_o, rays_d [..., 3] -> [..., 2]."""
    a = torch.sum(rays_d * rays_d, dim=-1)
    b = torch.sum(rays_o * rays_d, dim=-1)
    c = torch.sum(rays_o * rays_o, dim=-1) - radius * radius
    t = (-b + torch.sqrt(torch.clamp(b * b - a * c, min=0.0))) / a
    p = rays_o + t[..., None] * rays_d
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    theta = torch.atan2(torch.sqrt(x * x + z * z), y)
    phi = torch.atan2(z, x)
    return torch.stack([2.0 * theta / math.pi - 1.0, phi / math.pi], dim=-1)


class MarchResult(NamedTuple):
    ts: torch.Tensor      # [N, K] sample distances (0 where invalid)
    dts: torch.Tensor     # [N, K] integration step sizes
    mask: torch.Tensor    # [N, K] bool sample validity
    counts: torch.Tensor  # [N] int64 valid samples per ray


def _t_sequence(t0, *, dt_gamma: float, dt_min: float, dt_max: float,
                num_steps: int):
    """(ts, dts) [N, S] of the advance t += clamp(t * dt_gamma, dt_min,
    dt_max): closed form for dt_gamma == 0, else one step at a time over
    all rays (the JAX function's scan)."""
    if dt_gamma == 0.0:
        steps = torch.arange(num_steps, dtype=t0.dtype, device=t0.device)
        ts = t0[:, None] + steps[None, :] * dt_min
        return ts, torch.full_like(ts, dt_min)
    ts, dts = [], []
    t = t0
    for _ in range(num_steps):          # three launches a step
        dt = torch.mul(t, dt_gamma).clamp_(dt_min, dt_max)
        ts.append(t)
        dts.append(dt)
        t = t + dt
    return torch.stack(ts, 1), torch.stack(dts, 1)


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
    N = rays_o.shape[0]
    H = grid_size
    dt_min = 2.0 * SQRT3 / (dt_steps or max_steps)
    dt_max = 2.0 * SQRT3 * (2 ** (cascades - 1)) / H
    t0 = nears
    if perturb:
        if u is None:
            raise ValueError("march_rays: perturb=True needs the jitter u")
        t0 = t0 + dt_min * u
    ts, dts = _t_sequence(t0, dt_gamma=dt_gamma, dt_min=dt_min,
                          dt_max=dt_max, num_steps=max_steps)  # [N, S]
    p = [torch.clamp(rays_o[:, ax:ax + 1] + ts * rays_d[:, ax:ax + 1],
                     -bound, bound) for ax in range(3)]

    def cell(x):
        # truncation toward zero, as the JAX .astype(int32)
        return torch.clamp(x.to(torch.int32), 0, H - 1).to(torch.int64)

    if cascades == 1:
        inv2b = H / (2.0 * bound)
        c = [cell((x + bound) * inv2b) for x in p]
        flat = (c[0] * H + c[1]) * H + c[2]
    else:
        mx = torch.maximum(torch.abs(p[0]), torch.maximum(torch.abs(p[1]),
                                                          torch.abs(p[2])))
        e_pos = torch.frexp(mx).exponent
        e_dt = torch.frexp(dts * (H * 0.5)).exponent
        level = torch.clamp(torch.maximum(e_pos, e_dt), 0, cascades - 1)
        mip_bound = torch.clamp(torch.exp2(level.to(ts.dtype)), max=bound)
        half_h = 0.5 * H
        inv_mb = half_h / mip_bound
        c = [cell(x * inv_mb + half_h) for x in p]
        flat = level.to(torch.int64) * (H * H * H) + (c[0] * H + c[1]) * H \
            + c[2]
    occupied = occ[flat.reshape(-1)].reshape(N, max_steps) > 0
    keep = occupied & (ts < fars[:, None])                       # [N, S]

    total = torch.sum(keep.to(torch.int64), dim=-1)
    counts = torch.clamp(total, max=max_samples)
    k_eff = min(max_samples, max_steps)
    src = torch.argsort((~keep).to(torch.uint8), dim=-1,
                        stable=True)[:, :k_eff]
    valid = (torch.arange(max_samples, device=rays_o.device)[None, :]
             < counts[:, None])
    if dt_gamma == 0.0:
        # a constant step: ts is affine in the step index, so the
        # compacted buffers come straight from src, as in JAX
        ts_c = t0[:, None] + src.to(ts.dtype) * dt_min
        dts_c = torch.full_like(ts_c, dt_min)
    else:
        ts_c = torch.gather(ts, 1, src)
        dts_c = torch.gather(dts, 1, src)
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
