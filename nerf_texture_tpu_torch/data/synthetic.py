"""The synthetic textured-sphere scene, and fixtures for rendering
without a trained state.

``sphere_texture``, ``render_gt_sphere`` and ``SyntheticSphereDataset``
mirror ``nerf_texture_tpu/data/synthetic.py`` in host numpy, so that the
port needs nothing of the JAX package at run time (a test holds images,
poses and intrinsics equal).  ``sphere_intrinsics`` is the dataset's
camera; ``shell_occupancy`` is a density grid with a shell of high
density around the sphere's surface, what a trained grid of that scene
converges to, so the renderer's prepass and proxy sweep see real work.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.occupancy import OccupancyGrid
from .poses import orbit_pose


def sphere_texture(points: np.ndarray) -> np.ndarray:
    """Procedural RGB at surface points of the sphere."""
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    u = np.arctan2(z, x)
    v = np.arccos(np.clip(y / (np.linalg.norm(points, axis=-1) + 1e-9),
                          -1, 1))
    checker = ((np.floor(u / np.pi * 4) + np.floor(v / np.pi * 6)) % 2)
    r = 0.25 + 0.5 * checker
    g = 0.5 + 0.4 * np.sin(3 * u) * np.sin(4 * v)
    b = 0.3 + 0.5 * (1 - checker)
    return np.clip(np.stack([r, g, b], axis=-1), 0, 1)


def render_gt_sphere(pose, intrinsics, H, W, radius=0.5):
    """Analytic ground-truth render (ray-sphere hit, procedural texture,
    head-light shading): RGBA uint8 [H, W, 4]."""
    fx, fy, cx, cy = intrinsics
    j, i = np.meshgrid(np.arange(H, dtype=np.float32),
                       np.arange(W, dtype=np.float32), indexing="ij")
    xs = (i + 0.5 - cx) / fx
    ys = (j + 0.5 - cy) / fy
    dirs = np.stack([xs, ys, np.ones_like(xs)], axis=-1)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    rays_d = dirs @ pose[:3, :3].T
    o = pose[:3, 3]

    b = np.sum(rays_d * o, axis=-1)
    c = np.dot(o, o) - radius * radius
    disc = b * b - c
    hit = disc > 0
    t = -b - np.sqrt(np.maximum(disc, 0))
    hit &= t > 0
    pts = o + t[..., None] * rays_d
    rgb = sphere_texture(pts)
    n = pts / (np.linalg.norm(pts, axis=-1, keepdims=True) + 1e-9)
    shade = 0.4 + 0.6 * np.clip(-np.sum(n * rays_d, axis=-1), 0, 1)
    rgb = rgb * shade[..., None]
    rgba = np.zeros((H, W, 4), np.uint8)
    rgba[..., :3] = (np.clip(rgb, 0, 1) * 255).astype(np.uint8) \
        * hit[..., None]
    rgba[..., 3] = hit.astype(np.uint8) * 255
    return rgba


class SyntheticSphereDataset:
    """In-memory scene: ``n_frames`` orbit views of the textured sphere.

    poses [B, 4, 4] f32 cam2world, images [B, H, W, 4] uint8 RGBA,
    intrinsics [4] (fx, fy, cx, cy), H, W, radius, sphere_radius."""

    def __init__(self, n_frames: int = 24, H: int = 64, W: int = 64,
                 radius: float = 2.0, sphere_radius: float = 0.5,
                 focal: float | None = None, seed: int = 0):
        self.H, self.W = H, W
        focal = focal if focal is not None else 0.9 * max(H, W)
        self.intrinsics = np.array([focal, focal, W / 2, H / 2], np.float32)
        rng = np.random.default_rng(seed)
        poses, images = [], []
        for k in range(n_frames):
            phi = 2 * np.pi * k / n_frames
            theta = np.pi / 2 + 0.5 * np.sin(2 * phi) \
                + 0.05 * rng.standard_normal()
            pose = orbit_pose(theta, phi, radius)
            poses.append(pose)
            images.append(render_gt_sphere(pose, self.intrinsics, H, W,
                                           sphere_radius))
        self.poses = np.stack(poses).astype(np.float32)
        self.images = np.stack(images)
        self.radius = radius
        self.sphere_radius = sphere_radius

    @property
    def num_frames(self) -> int:
        return self.poses.shape[0]


def sphere_intrinsics(H: int, W: int, focal: float | None = None
                      ) -> np.ndarray:
    """[4] (fx, fy, cx, cy) of SyntheticSphereDataset(H=H, W=W)."""
    focal = focal if focal is not None else 0.9 * max(H, W)
    return np.array([focal, focal, W / 2, H / 2], np.float32)


def shell_occupancy(grid_size: int, *, radius: float = 0.5,
                    half_width_cells: float = 1.0, sigma: float = 20.0,
                    bound: float = 1.0, density_thresh: float = 0.01,
                    device: torch.device | str = "cuda") -> OccupancyGrid:
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
