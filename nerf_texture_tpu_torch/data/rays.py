"""Ray generation (port of ``nerf_texture_tpu/data/rays.py``): pixel-center
rays in the ngp camera convention (the camera looks along +z of the c2w
rotation), and the pixel sampling of training: uniform, or weighted by
an error map."""

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


def error_map_draws(generator: torch.Generator, n: int,
                    coarse: int = 128):
    """The uniform draws of error-map sampling on the generator's device:
    [coarse^2] in [1e-9, 1) for the Gumbel noise (as JAX's
    ``uniform(minval=1e-9)``), and two [n] in [0, 1) for the jitter of
    the rows and the columns within a cell."""
    dev = generator.device
    u = torch.rand((coarse * coarse,), generator=generator, device=dev)
    u = torch.clamp(u * (1.0 - 1e-9) + 1e-9, min=1e-9)
    jx = torch.rand((n,), generator=generator, device=dev)
    jy = torch.rand((n,), generator=generator, device=dev)
    return u, jx, jy


def sample_ray_indices(generator: torch.Generator | None, H: int, W: int,
                       n: int, error_map=None, *, draws=None,
                       coarse: int = 128):
    """Pixel indices of a training step.

    Without ``error_map``: n uniform random indices in [0, H*W) on the
    generator's device; returns (inds [n] int64, None).

    With ``error_map`` [coarse^2]: n cells of the coarse map drawn without
    replacement in proportion to the error (a Gumbel top-k: the cells by
    log(error) + Gumbel noise, descending, ties to the lower cell as
    ``lax.top_k`` orders them), then a jittered pixel inside each cell;
    ``draws`` = (u [coarse^2], jx [n], jy [n]) as ``error_map_draws``
    makes them (drawn from ``generator`` when not given).  Returns
    (inds [n] int64, inds_coarse [n] int64)."""
    if error_map is None:
        return torch.randint(0, H * W, (n,), generator=generator,
                             device=generator.device), None
    if error_map.shape != (coarse * coarse,):
        raise ValueError(f"sample_ray_indices: the error map is "
                         f"{tuple(error_map.shape)}, not [{coarse * coarse}]")
    u, jx, jy = draws if draws is not None else error_map_draws(
        generator, n, coarse)
    logits = torch.log(torch.clamp(error_map, min=1e-12))
    gumbel = -torch.log(-torch.log(u))
    # a stable descending sort keeps equal keys in index order
    order = torch.sort(logits + gumbel, descending=True, stable=True)[1]
    inds_coarse = order[:n]
    sx, sy = H / coarse, W / coarse
    px = torch.clamp(((inds_coarse // coarse) * sx + jx * sx).to(
        torch.int32), 0, H - 1)
    py = torch.clamp(((inds_coarse % coarse) * sy + jy * sy).to(
        torch.int32), 0, W - 1)
    return px.to(torch.int64) * W + py.to(torch.int64), inds_coarse
