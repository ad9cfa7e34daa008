"""Camera poses (numpy): ``orbit_pose``, ``rand_poses``, the NeRF-to-ngp
axis change and the camera normalisation of a captured scene
(``nerf_matrix_to_ngp``, ``min_line_dist_center``, ``centralize_cps``,
``normalize_cps``), as in
``nerf_texture_tpu/data/poses.py`` statement for statement, kept here so
that the port needs nothing of the JAX package at run time (tests hold
them equal bit for bit)."""

from __future__ import annotations

import numpy as np


def orbit_pose(theta: float, phi: float, radius: float) -> np.ndarray:
    """c2w pose on an orbit looking at the origin (ngp convention: the
    camera looks along the +z column of its rotation)."""
    center = np.array([
        radius * np.sin(theta) * np.sin(phi),
        radius * np.cos(theta),
        radius * np.sin(theta) * np.cos(phi),
    ], dtype=np.float32)
    forward = -center / (np.linalg.norm(center) + 1e-10)
    up = np.array([0.0, -1.0, 0.0], dtype=np.float32)
    right = np.cross(forward, up)
    right /= np.linalg.norm(right) + 1e-10
    up = np.cross(right, forward)
    up /= np.linalg.norm(up) + 1e-10
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = np.stack([right, up, forward], axis=-1)
    pose[:3, 3] = center
    return pose


def nerf_matrix_to_ngp(pose: np.ndarray, scale: float = 0.33) -> np.ndarray:
    """Axis permutation + flip from the NeRF/Blender convention to ngp's."""
    return np.array([
        [pose[1, 0], -pose[1, 1], -pose[1, 2], pose[1, 3] * scale],
        [pose[2, 0], -pose[2, 1], -pose[2, 2], pose[2, 3] * scale],
        [pose[0, 0], -pose[0, 1], -pose[0, 2], pose[0, 3] * scale],
        [0, 0, 0, 1],
    ], dtype=np.float32)


def min_line_dist_center(rays_o: np.ndarray, rays_d: np.ndarray):
    """Point minimizing total squared distance to the camera view lines."""
    if rays_d.ndim == 2:
        rays_o = rays_o[..., np.newaxis]
        rays_d = rays_d[..., np.newaxis]
    A_i = np.eye(3) - rays_d * np.transpose(rays_d, [0, 2, 1])
    b_i = -A_i @ rays_o
    return np.squeeze(-np.linalg.inv((A_i @ A_i).mean(0)) @ b_i.mean(0))


def centralize_cps(cps: np.ndarray) -> np.ndarray:
    cps = np.array(cps, dtype=np.float32)
    center = min_line_dist_center(cps[:, :3, 3], cps[:, :3, 2])
    cps[:, :3, 3] -= center
    return cps


def normalize_cps(cps: np.ndarray, scale: float = 1.2):
    """Centralize, then scale camera distances so max radius ~= scale."""
    cps = centralize_cps(cps)
    dists = np.linalg.norm(cps[:, :3, 3], axis=-1)
    radius = 1.1 * np.max(dists) + 1e-5
    cps[:, :3, 3] /= radius / scale
    return cps, radius


def rand_poses(rng: np.random.Generator, size: int, radius: float = 1.0,
               theta_range=(np.pi / 3, 2 * np.pi / 3),
               phi_range=(0, 2 * np.pi)) -> np.ndarray:
    """[size, 4, 4] orbit poses at uniform random (theta, phi) drawn from
    ``rng`` (all thetas first, then all phis)."""
    thetas = rng.uniform(*theta_range, size)
    phis = rng.uniform(*phi_range, size)
    return np.stack([orbit_pose(t, p, radius)
                     for t, p in zip(thetas, phis)], axis=0)
