"""Ray generation (port of ``nerf_texture_tpu/data/rays.py``): pixel-center
rays in the ngp camera convention (the camera looks along +z of the c2w
rotation), and random pixel sampling for training."""

from __future__ import annotations

import torch


def pixel_dirs(intrinsics: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """[H*W, 3] unnormalised camera-space directions at pixel centers."""
    fx, fy, cx, cy = intrinsics[0], intrinsics[1], intrinsics[2], intrinsics[3]
    j, i = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=intrinsics.device),
        torch.arange(W, dtype=torch.float32, device=intrinsics.device),
        indexing="ij")
    i = i.reshape(-1) + 0.5
    j = j.reshape(-1) + 0.5
    xs = (i - cx) / fx
    ys = (j - cy) / fy
    return torch.stack([xs, ys, torch.ones_like(xs)], dim=-1)


def rotate(dirs: torch.Tensor, rot: torch.Tensor) -> torch.Tensor:
    """dirs [N, 3] @ rot[3, 3].T as three f32 multiply-adds per lane, so
    the rays do not depend on the TF32 matmul setting."""
    return (dirs[:, 0:1] * rot[:, 0] + dirs[:, 1:2] * rot[:, 1]
            + dirs[:, 2:3] * rot[:, 2])


def get_rays(pose: torch.Tensor, intrinsics: torch.Tensor, H: int, W: int,
             inds: torch.Tensor | None = None) -> dict[str, torch.Tensor]:
    """Rays for one camera: pose [4, 4] cam2world, intrinsics [4]
    (fx, fy, cx, cy), optional [N] flat pixel indices.  Returns
    dict(rays_o [N, 3], rays_d [N, 3] unit, inds [N])."""
    dirs = pixel_dirs(intrinsics, H, W)
    if inds is None:
        inds = torch.arange(H * W, device=dirs.device)
    else:
        dirs = dirs[inds]
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    rays_d = rotate(dirs, pose[:3, :3])
    rays_o = pose[:3, 3].expand(rays_d.shape)
    return {"rays_o": rays_o, "rays_d": rays_d, "inds": inds}


def sample_ray_indices(generator: torch.Generator, H: int, W: int, n: int,
                       error_map=None):
    """n uniform random pixel indices in [0, H*W) on the generator's
    device.  Returns (inds [n] int64, None), as the JAX function does
    without an error map."""
    if error_map is not None:
        raise NotImplementedError(
            "sample_ray_indices: error-map importance sampling is not "
            "ported; ROADMAP Queue 1, item 11.4")
    return torch.randint(0, H * W, (n,), generator=generator,
                         device=generator.device), None
