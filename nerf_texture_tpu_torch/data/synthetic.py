"""Synthetic-sphere scene fixtures for rendering without a trained state.

``sphere_intrinsics`` is the camera of
``nerf_texture_tpu.data.synthetic.SyntheticSphereDataset`` (a test holds
the two equal); ``shell_occupancy`` is a density grid with a shell of high
density around the sphere's surface, what a trained grid of that scene
converges to, so the renderer's prepass and proxy sweep see real work.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.occupancy import OccupancyGrid


def sphere_intrinsics(H: int, W: int, focal: float | None = None
                      ) -> np.ndarray:
    """[4] (fx, fy, cx, cy) of SyntheticSphereDataset(H=H, W=W)."""
    focal = focal if focal is not None else 0.9 * max(H, W)
    return np.array([focal, focal, W / 2, H / 2], np.float32)


def shell_occupancy(grid_size: int, *, radius: float = 0.5,
                    half_width_cells: float = 1.0, sigma: float = 20.0,
                    bound: float = 1.0, density_thresh: float = 0.01,
                    device: torch.device | str = "cpu") -> OccupancyGrid:
    """Cascade-0 grid: density ``sigma`` in cells whose center lies within
    ``half_width_cells`` cells of the sphere |x| = radius (a shell about
    2 cells thick), 0 elsewhere; occ = density > density_thresh."""
    H = grid_size
    cell = 2.0 * bound / H
    c = (torch.arange(H, dtype=torch.float32, device=device) + 0.5) \
        * cell - bound
    r = torch.sqrt(c[:, None, None] ** 2 + c[None, :, None] ** 2
                   + c[None, None, :] ** 2)
    dens = torch.where(torch.abs(r - radius) < half_width_cells * cell,
                       sigma, 0.0).reshape(1, -1)
    return OccupancyGrid(
        density=dens,
        occ=(dens[0] > density_thresh).to(torch.uint8),
        mean_density=dens.mean(),
        iter_density=torch.zeros((), dtype=torch.int32, device=device))
