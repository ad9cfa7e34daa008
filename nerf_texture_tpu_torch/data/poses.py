"""Camera poses (numpy): ``orbit_pose`` as in
``nerf_texture_tpu/data/poses.py``, kept here so that the port needs
nothing of the JAX package at run time (a test holds the two equal)."""

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
