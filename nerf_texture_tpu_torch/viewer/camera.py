"""Interactive orbit camera (port of ``nerf_texture_tpu/viewer/camera.py``;
numpy only)."""

from __future__ import annotations

import numpy as np


def axis_angle_to_matrix(rotvec: np.ndarray) -> np.ndarray:
    """Rodrigues formula in f32: [3] axis-angle -> [3, 3] rotation, the
    same expression as ``utils.transforms.axis_angle_to_matrix``."""
    rotvec = np.asarray(rotvec, np.float32)
    theta = np.sqrt(np.sum(rotvec * rotvec, axis=-1, keepdims=True)
                    + np.float32(1e-16))
    x, y, z = rotvec / theta
    zero = np.float32(0.0)
    K = np.array([[zero, -z, y], [z, zero, -x], [-y, x, zero]], np.float32)
    t = theta[0]
    return (np.eye(3, dtype=np.float32) + np.sin(t) * K
            + (np.float32(1.0) - np.cos(t)) * (K @ K))


class OrbitCamera:
    """Orbit camera in the ngp convention (the camera looks along +z of
    its rotation; pose = cam2world)."""

    def __init__(self, W: int = 800, H: int = 800, radius: float = 2.0,
                 fovy: float = 50.0):
        self.W, self.H = W, H
        self.radius = radius
        self.fovy = fovy
        self.center = np.zeros(3, np.float32)
        self.rot = np.eye(3, dtype=np.float32)

    @property
    def pose(self) -> np.ndarray:
        pose = np.eye(4, dtype=np.float32)
        pose[:3, :3] = self.rot
        pose[:3, 3] = self.center - self.rot[:, 2] * self.radius
        return pose

    @property
    def intrinsics(self) -> np.ndarray:
        focal = self.H / (2 * np.tan(np.radians(self.fovy) / 2))
        return np.array([focal, focal, self.W / 2, self.H / 2],
                        np.float32)

    def orbit(self, dx: float, dy: float):
        up = self.rot[:, 1]
        side = self.rot[:, 0]
        rot_x = axis_angle_to_matrix(-dx * 0.005 * up)
        rot_y = axis_angle_to_matrix(-dy * 0.005 * side)
        self.rot = rot_x @ rot_y @ self.rot

    def scale(self, delta: float):
        self.radius *= 1.1 ** (-delta)

    def pan(self, dx: float, dy: float, dz: float = 0.0):
        self.center += 2e-4 * self.rot @ np.array([dx, dy, dz],
                                                  np.float32)
