"""Rotations (port of ``nerf_texture_tpu/utils/transforms.py``): the
Rodrigues formula for the trainable camera deltas, differentiable at 0."""

from __future__ import annotations

import torch


def axis_angle_to_matrix(rotvec: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula: [..., 3] axis-angle -> [..., 3, 3] rotation.

    theta is sqrt(|v|^2 + 1e-16), so the gradient at rotvec = 0 (where
    the camera deltas start) is finite."""
    theta = torch.sqrt(torch.sum(rotvec * rotvec, dim=-1, keepdim=True)
                       + 1e-16)
    axis = rotvec / theta
    x, y, z = axis[..., 0], axis[..., 1], axis[..., 2]
    zero = torch.zeros_like(x)
    K = torch.stack([
        torch.stack([zero, -z, y], -1),
        torch.stack([z, zero, -x], -1),
        torch.stack([-y, x, zero], -1),
    ], -2)
    t = theta[..., None]
    eye = torch.eye(3, dtype=rotvec.dtype, device=rotvec.device).expand(
        K.shape)
    return eye + torch.sin(t) * K + (1.0 - torch.cos(t)) * (K @ K)


def euler_to_matrix(euler) -> torch.Tensor:
    """A rotation vector [3] (the viewer's light-rotation sliders) ->
    [3, 3], through ``axis_angle_to_matrix``."""
    return axis_angle_to_matrix(torch.as_tensor(euler))
