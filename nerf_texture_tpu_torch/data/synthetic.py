"""The synthetic scenes (the textured sphere and the textured bumpy
shell), and fixtures for rendering without a trained state.

``sphere_texture``, ``render_gt_sphere``, ``SyntheticSphereDataset`` and
the shell's ``shell_radius``, ``shell_texture``, ``render_gt_shell`` and
``SyntheticShellDataset`` mirror ``nerf_texture_tpu/data/synthetic.py``
in host numpy, statement for statement, so that the port needs nothing
of the JAX package at run time (tests hold images, poses and intrinsics
equal bit for bit); ``write_to_disk`` writes the scene as a
``transforms.json`` directory that ``data.provider.NeRFDataset`` (and the
JAX package's loader) reads.  ``sphere_intrinsics`` is the dataset's
camera; ``shell_occupancy`` is a density grid with a shell of high
density around the sphere's surface, what a trained grid of that scene
converges to, so the renderer's prepass and proxy sweep see real work.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..ops.occupancy import OccupancyGrid
from .images import write_png
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

    def write_to_disk(self, path: str):
        """Write the scene as a colmap-mode ``transforms.json`` directory,
        the images as 8-bit RGBA PNGs under ``images/``.  The poses are
        written in the NeRF/Blender convention at scale 1, so that
        ``nerf_matrix_to_ngp`` with ``scale=1`` gives them back."""
        os.makedirs(os.path.join(path, "images"), exist_ok=True)
        frames = []
        for k in range(self.num_frames):
            ngp = self.poses[k]
            # invert nerf_matrix_to_ngp (scale=1): rows (1,2,0) with sign
            # flips on the last two columns
            nerf = np.eye(4, dtype=np.float32)
            nerf[0] = [ngp[2, 0], -ngp[2, 1], -ngp[2, 2], ngp[2, 3]]
            nerf[1] = [ngp[0, 0], -ngp[0, 1], -ngp[0, 2], ngp[0, 3]]
            nerf[2] = [ngp[1, 0], -ngp[1, 1], -ngp[1, 2], ngp[1, 3]]
            name = f"images/frame_{k:04d}.png"
            write_png(os.path.join(path, name), self.images[k])
            frames.append({"file_path": name,
                           "transform_matrix": nerf.tolist()})
        meta = {
            "fl_x": float(self.intrinsics[0]),
            "fl_y": float(self.intrinsics[1]),
            "cx": float(self.intrinsics[2]),
            "cy": float(self.intrinsics[3]),
            "h": self.H, "w": self.W,
            "frames": frames,
        }
        with open(os.path.join(path, "transforms.json"), "w") as f:
            json.dump(meta, f)


# ---------------------------------------------------------------------------
# the textured bumpy shell: the parity pipeline's scene
# ---------------------------------------------------------------------------


def shell_radius(dirs: np.ndarray, base: float = 0.5,
                 bump_amp: float = 0.035) -> np.ndarray:
    """Radial displacement rho(direction) of a smooth bumpy shell: fine
    repeating relief riding a sphere of radius ``base``."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    u = np.arctan2(z, x)
    v = np.arccos(np.clip(y, -1.0, 1.0))
    bumps = (np.sin(8 * u) * np.sin(9 * v)
             + 0.6 * np.sin(17 * u + 1.3) * np.sin(13 * v + 0.7))
    return base * (1.0 + bump_amp * bumps)


def shell_texture(dirs: np.ndarray) -> np.ndarray:
    """High-frequency albedo over the shell (stripes and spots)."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    u = np.arctan2(z, x)
    v = np.arccos(np.clip(y, -1.0, 1.0))
    stripes = 0.5 + 0.5 * np.sin(24 * u + 4 * np.sin(3 * v))
    spots = (np.sin(15 * u) * np.sin(21 * v)) ** 2
    r = 0.25 + 0.55 * stripes
    g = 0.30 + 0.45 * spots
    b = 0.55 - 0.35 * stripes + 0.25 * spots
    return np.clip(np.stack([r, g, b], axis=-1), 0.0, 1.0)


def _shell_sdf(p: np.ndarray, base: float, bump_amp: float) -> np.ndarray:
    rad = np.linalg.norm(p, axis=-1)
    dirs = p / np.maximum(rad[..., None], 1e-9)
    return rad - shell_radius(dirs, base, bump_amp)


def render_gt_shell(pose, intrinsics, H, W, base=0.5, bump_amp=0.035,
                    n_march=96, n_bisect=12,
                    light_dir=(0.4, -0.8, 0.45)):
    """Analytic ground truth of the bumpy textured shell: a fixed-step
    march and a bisection on the radial implicit, Lambertian shading
    under a fixed directional light plus a head light.  RGBA uint8
    [H, W, 4]."""
    fx, fy, cx, cy = intrinsics
    j, i = np.meshgrid(np.arange(H, dtype=np.float32),
                       np.arange(W, dtype=np.float32), indexing="ij")
    xs = (i + 0.5 - cx) / fx
    ys = (j + 0.5 - cy) / fy
    dirs = np.stack([xs, ys, np.ones_like(xs)], axis=-1)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    rays_d = (dirs @ pose[:3, :3].T).reshape(-1, 3)
    o = pose[:3, 3].astype(np.float64)

    r_max = base * (1.0 + abs(bump_amp) * 1.7)
    b = np.sum(rays_d * o, axis=-1)
    c = float(np.dot(o, o)) - r_max * r_max
    disc = b * b - c
    may_hit = disc > 0
    t0 = np.where(may_hit, -b - np.sqrt(np.maximum(disc, 0.0)), 0.0)
    t1 = np.where(may_hit, -b + np.sqrt(np.maximum(disc, 0.0)), 0.0)

    # fixed-step march: the first sign change of the radial implicit
    ts = np.linspace(0.0, 1.0, n_march, dtype=np.float64)
    lo = np.zeros_like(t0)
    hi = np.zeros_like(t0)
    hit = np.zeros(t0.shape, bool)
    prev_t = t0.copy()
    prev_s = _shell_sdf(o + t0[:, None] * rays_d, base, bump_amp)
    for k in range(1, n_march):
        t = t0 + (t1 - t0) * ts[k]
        s = _shell_sdf(o + t[:, None] * rays_d, base, bump_amp)
        new = (~hit) & may_hit & (prev_s > 0) & (s <= 0)
        lo = np.where(new, prev_t, lo)
        hi = np.where(new, t, hi)
        hit |= new
        prev_t, prev_s = t, s
    for _ in range(n_bisect):
        mid = 0.5 * (lo + hi)
        s = _shell_sdf(o + mid[:, None] * rays_d, base, bump_amp)
        inside = s <= 0
        hi = np.where(hit & inside, mid, hi)
        lo = np.where(hit & ~inside, mid, lo)
    t_hit = 0.5 * (lo + hi)
    pts = o + t_hit[:, None] * rays_d

    # shading normal: the central-difference gradient of the implicit
    eps = 1e-4
    grad = np.stack([
        _shell_sdf(pts + np.array([eps, 0, 0]), base, bump_amp)
        - _shell_sdf(pts - np.array([eps, 0, 0]), base, bump_amp),
        _shell_sdf(pts + np.array([0, eps, 0]), base, bump_amp)
        - _shell_sdf(pts - np.array([0, eps, 0]), base, bump_amp),
        _shell_sdf(pts + np.array([0, 0, eps]), base, bump_amp)
        - _shell_sdf(pts - np.array([0, 0, eps]), base, bump_amp),
    ], axis=-1)
    n = grad / np.maximum(np.linalg.norm(grad, axis=-1, keepdims=True),
                          1e-12)
    ldir = np.asarray(light_dir, np.float64)
    ldir = ldir / np.linalg.norm(ldir)
    lam = np.clip(np.sum(n * ldir, axis=-1), 0.0, 1.0)
    head = np.clip(-np.sum(n * rays_d, axis=-1), 0.0, 1.0)
    shade = 0.35 + 0.5 * lam + 0.15 * head

    sdirs = pts / np.maximum(np.linalg.norm(pts, axis=-1, keepdims=True),
                             1e-9)
    rgb = shell_texture(sdirs) * shade[:, None]
    rgba = np.zeros((H * W, 4), np.uint8)
    rgba[:, :3] = (np.clip(rgb, 0, 1) * 255).astype(np.uint8) \
        * hit[:, None]
    rgba[:, 3] = hit.astype(np.uint8) * 255
    return rgba.reshape(H, W, 4)


class SyntheticShellDataset(SyntheticSphereDataset):
    """In-memory scene: ``n_frames`` orbit views of the bumpy, textured
    shell (the interface of ``SyntheticSphereDataset``, plus ``base`` and
    ``bump_amp``; ``sphere_radius`` is the base radius)."""

    def __init__(self, n_frames: int = 24, H: int = 64, W: int = 64,
                 radius: float = 2.0, base: float = 0.5,
                 bump_amp: float = 0.035, focal: float | None = None,
                 seed: int = 0):
        self.H, self.W = H, W
        focal = focal if focal is not None else 0.9 * max(H, W)
        self.intrinsics = np.array([focal, focal, W / 2, H / 2],
                                   np.float32)
        rng = np.random.default_rng(seed)
        poses, images = [], []
        for k in range(n_frames):
            phi = 2 * np.pi * k / n_frames
            theta = np.pi / 2 + 0.5 * np.sin(2 * phi) \
                + 0.05 * rng.standard_normal()
            pose = orbit_pose(theta, phi, radius)
            poses.append(pose)
            images.append(render_gt_shell(pose, self.intrinsics, H, W,
                                          base, bump_amp))
        self.poses = np.stack(poses).astype(np.float32)
        self.images = np.stack(images)
        self.radius = radius
        self.sphere_radius = base
        self.base = base
        self.bump_amp = bump_amp


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
