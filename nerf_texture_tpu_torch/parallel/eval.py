"""Multi-rank full-frame rendering: the frame split over the mesh's data
axis (port of ``nerf_texture_tpu/parallel/eval.py``).

The band path: the frame is split into scanline bands, one per data
rank, and each rank renders its band through the single-rank frame
pipeline (``render.renderer.render_image`` with the band's first row:
block prepass, live compaction, the proxy sweep and the survivor-
selection kernel in every chunk) with no collective; one gather of the
bands follows.  Unlike the JAX package's band (whose tau carve clamps
its 3x3 block neighbourhoods at the band's edges, so a seam's blocks can
be culled or windowed otherwise than in the single-device frame), the
band's block prepass also covers one block row above and below it,
which are not rendered: a band frame is the single-rank frame, but
where the tau sweep's cap of 4096 hit blocks binds (each band sweeps
4096 of its own).

The fallback (no density grid, the pool path, more than one cascade, an
image background): fixed chunks of the frame's rays, each split over the
data ranks and rendered through ``render_rays`` (the pool path), then
the same gather.

Ranks of one data index (a model group) render the same rays in
lockstep; their tensor-parallel MLPs reduce over the model group.
"""

from __future__ import annotations

import warnings

import torch

from ..data.rays import get_rays
from ..render.renderer import (DEFERRED_IGNORED, PrepassState,
                               RenderConfig, _bind, _frame_buffer_packed,
                               render_image, render_rays)
from .sharding import Mesh


@torch.no_grad()
def render_image_sharded(field_apply, field_static, params, occ, pose,
                         intrinsics, H: int, W: int, cfg: RenderConfig,
                         mesh: Mesh, *, bg_color=1.0, anchor_apply=None,
                         density=None, deferred_apply=None,
                         prepass: PrepassState | None = None,
                         plain_select: bool = False):
    """``render_image`` with the frame split across ``mesh``'s data axis.

    params: this rank's params (replicated, or split by
    ``parallel.shard_params``); occ: the occupancy grid's [cascades *
    H^3] uint8 mask and ``density`` its density grid (both replicated);
    ``prepass``: their ``PrepassState`` under ``cfg`` if already built.
    With ``density`` and a single-cascade proxy config each data rank
    renders one scanline band through the full pipeline; otherwise the
    chunk-split fallback runs.  ``plain_select`` runs the plain
    selections in place of the kernels (see ``render_rays_proxy``).
    ``deferred_apply``: the field's deferred stage pair (see
    ``render_image``), which each band's chunks run; the chunk-split
    fallback ignores it, as the JAX package's does, with a warning.
    Returns dict(image [H, W, 3], depth [H, W], weights_sum [H, W],
    live: this rank's live rays, chunks: this rank's chunks)."""
    if density is not None and cfg.infer_mode == "proxy" \
            and cfg.cascades == 1:
        if prepass is None:
            prepass = PrepassState.build(occ, cfg, density=density)
        out = _render_sharded_bands(field_apply, field_static, params,
                                    prepass, pose, intrinsics, H, W, cfg,
                                    mesh, bg_color=bg_color,
                                    anchor_apply=anchor_apply,
                                    deferred_apply=deferred_apply,
                                    plain_select=plain_select)
        if out is not None:
            return out
    if deferred_apply is not None:
        warnings.warn(DEFERRED_IGNORED["chunks"])
    return _render_sharded_chunks(field_apply, field_static, params, occ,
                                  pose, intrinsics, H, W, cfg, mesh,
                                  bg_color=bg_color)


def _frame_out(frame, H: int, W: int, live: int, chunks: int) -> dict:
    return {"image": frame[:H * W, :3].reshape(H, W, 3),
            "depth": frame[:H * W, 3].reshape(H, W),
            "weights_sum": frame[:H * W, 4].reshape(H, W),
            "live": live, "chunks": chunks}


def _render_sharded_bands(field_apply, field_static, params,
                          prepass: PrepassState, pose, intrinsics, H: int,
                          W: int, cfg: RenderConfig, mesh: Mesh, *,
                          bg_color, anchor_apply, deferred_apply,
                          plain_select: bool):
    """One band a data rank: band_H = ceil(H / ranks) rounded up to the
    prepass block, so the bands' block rows align with the single-rank
    frame's; the last band may run past the frame (cropped).  None where
    the band path does not apply (the caller falls back)."""
    bg = torch.as_tensor(bg_color, dtype=torch.float32)
    if bg.numel() not in (1, 3):
        return None                      # full bg images: fallback path
    if prepass.aabb_np is None or prepass.occ_dil is None \
            or prepass.dens8 is None:
        return None
    n_b = mesh.shape["data"]
    B = max(1, cfg.prepass_block)
    band_H = -(-H // n_b)
    band_H = -(-band_H // B) * B
    row0 = mesh.data_index * band_H
    # the band's rows within the frame (the last bands may run past it)
    rows = max(0, min(band_H, H - row0))
    local = torch.zeros((band_H * W, 5), device=mesh.device)
    live = chunks = 0
    if rows:
        band = render_image(field_apply, field_static, params, prepass, pose,
                            intrinsics, rows, W, cfg, bg_color=bg_color,
                            anchor_apply=anchor_apply,
                            deferred_apply=deferred_apply,
                            plain_select=plain_select, row0=row0,
                            frame_rows=H)
        local[:rows * W] = torch.cat([band["image"].reshape(-1, 3),
                                      band["depth"].reshape(-1, 1),
                                      band["weights_sum"].reshape(-1, 1)],
                                     dim=-1)
        live, chunks = band["live"], band["chunks"]
    frame = mesh.gather(local, [band_H * W] * n_b, "data")
    return _frame_out(frame, H, W, live, chunks)


def _render_sharded_chunks(field_apply, field_static, params, occ, pose,
                           intrinsics, H: int, W: int, cfg: RenderConfig,
                           mesh: Mesh, *, bg_color=1.0):
    """Fixed chunks of the frame (a multiple of the data ranks; the last
    one overlaps the one before so that every chunk is whole), each
    rank's contiguous share of each through the pool render, whose
    per-ray cap is the whole chunk's.  Each pixel is written by one rank
    into a zeroed frame, which one all-reduce assembles."""
    device = mesh.device
    pose = torch.as_tensor(pose, dtype=torch.float32, device=device)
    intr = torch.as_tensor(intrinsics, dtype=torch.float32, device=device)
    rays = get_rays(pose, intr, H, W)
    n = H * W
    n_shards = mesh.shape["data"]
    chunk = min(cfg.ray_chunk, n)
    chunk -= chunk % max(n_shards, 1) or 0
    chunk = max(chunk, n_shards)
    share = chunk // n_shards
    field_fn = _bind(params, field_static, field_apply, None, None, None)[0]
    bg = _frame_buffer_packed(bg_color, n=n, device=device)[:, :3]
    frame = torch.zeros((n, 5), device=device)
    live = chunks = 0
    for start in range(0, n, chunk):
        stop = min(start + chunk, n)
        first = start - (chunk - (stop - start))
        lo = first + mesh.data_index * share
        idx = torch.arange(lo, lo + share, device=device)
        out = render_rays(
            field_fn, occ, rays["rays_o"][idx], rays["rays_d"][idx], cfg,
            max_samples=cfg.max_samples_infer, bg_color=bg[idx],
            march_steps=cfg.march_steps_infer or None,
            pool_mean=(cfg.pool_mean_samples_infer
                       if cfg.pool_mean_samples else 0),
            pool_rays=chunk)
        rows = torch.cat([out["image"], out["depth"][:, None],
                          out["weights_sum"][:, None]], dim=-1)
        # the overlap's rows were written by the chunk before
        keep = idx >= start
        frame[idx[keep]] = rows[keep]
        live += int(share)
        chunks += 1
    mesh.all_reduce(frame, "data")
    return _frame_out(frame, H, W, live, chunks)
