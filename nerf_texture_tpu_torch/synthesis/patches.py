"""Patch sampling: export implicit texture patches from a trained surface
field (port of ``nerf_texture_tpu/synthesis/patches.py``).

Up to ``max_patch_num`` centres are spread over the mesh (area-weighted
samples thinned by farthest-point selection); each gets a local frame
aligned with the mesh's first principal axis, and a patch_size^2 grid of
rays along -normal is cast onto the mesh.  A patch is kept if it lies
above y = 0 (or, with a scan point cloud, close to the scan) and all its
rays hit; its texels are then projected (``projector.project``) and
encoded: the packed hash-grid features and the phi embedding at the
surface points, and the local TBN of the hit face.

The host half (centre sampling, frames, rejections) is numpy, mirrored
statement for statement, so both packages draw the same centres from the
same seed.  The device half runs ``center_batch`` centres at a time
(``center_batch`` x patch_size^2 rays a call) under ``no_grad``; only the
kept centres' texels are projected and encoded (each texel on its own,
so the values are those of the whole batch).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from scipy.spatial import cKDTree

from ..geometry import projector as proj
from ..geometry.mesh import Mesh
from ..geometry.spatial import raycast
from ..models import normal_net
from ..models.mesh_field import MeshFieldConfig, MeshFieldState
from ..ops.hashgrid_packed import packed_encode_bound


@dataclasses.dataclass
class PatchSampleConfig:
    """Every field of the JAX PatchSampleConfig: texels a side, the patch
    budget, texel spacing as a fraction of the mean edge, centres a
    device call, the scan-distance veto, whether to keep each patch's
    rays, the centre seed, and the centres drawn per requested patch
    (rejection discards some)."""

    patch_size: int = 128
    max_patch_num: int = 2000
    pattern_rate: float = 1 / 50
    center_batch: int = 16
    scan_dist_factor: float = 3.0
    record_rays: bool = False
    seed: int = 0
    center_oversample: float = 2.0


def poisson_disk_sample(mesh: Mesh, n: int, seed: int = 0,
                        face_subset: np.ndarray | None = None
                        ) -> np.ndarray:
    """Approximate poisson-disk surface sampling: dense area-weighted
    samples, then greedy farthest-point thinning to n.  ``face_subset``
    restricts the samples to those faces."""
    rng = np.random.default_rng(seed)
    dense = sample_surface(mesh, max(4 * n, 2000), rng,
                           face_subset=face_subset)
    chosen = [int(rng.integers(len(dense)))]
    d2 = ((dense - dense[chosen[0]]) ** 2).sum(-1)
    for _ in range(min(n, len(dense)) - 1):
        idx = int(np.argmax(d2))
        chosen.append(idx)
        d2 = np.minimum(d2, ((dense - dense[idx]) ** 2).sum(-1))
    return dense[chosen]


def sample_surface(mesh: Mesh, n: int, rng,
                   face_subset: np.ndarray | None = None) -> np.ndarray:
    """n area-weighted uniform points on the mesh (or on face_subset)."""
    areas = mesh.face_areas
    if face_subset is not None and len(face_subset):
        mask = np.zeros(len(areas), bool)
        mask[np.asarray(face_subset, np.int64)] = True
        areas = np.where(mask, areas, 0.0)
    probs = areas / areas.sum()
    fids = rng.choice(len(areas), size=n, p=probs)
    tris = mesh.vertices[mesh.faces[fids]]
    u = rng.uniform(size=(n, 1))
    v = rng.uniform(size=(n, 1))
    flip = (u + v) > 1
    u = np.where(flip, 1 - u, u)
    v = np.where(flip, 1 - v, v)
    return (tris[:, 0] * (1 - u - v) + tris[:, 1] * u + tris[:, 2] * v)


def pca_first_component(points: np.ndarray) -> np.ndarray:
    centered = points - points.mean(0)
    _, _, vt = np.linalg.svd(centered, full_matrices=False)
    return vt[0]


@torch.no_grad()
def encode_texels(field_params, state: MeshFieldState, cfg: MeshFieldConfig,
                  p_hit: torch.Tensor):
    """The exported channels of texels that hit the mesh at p_hit [P, 3]:
    (features [P, L * C], phi embedding [P, P_phi] (zeros [P, 1] without
    ``pred_normal``), local TBN [P, 3, 3]), at their exact projection."""
    p_sur, _, _, _, local_tbn = proj.project(
        state.projector, p_hit, k=cfg.k, h_threshold=cfg.h_threshold)
    feat = packed_encode_bound(p_sur, field_params["encoder"],
                               cfg.feature_spec, bound=cfg.bound)
    phi = (normal_net.phi_embedding(field_params["normal"], p_sur,
                                    cfg.normal_cfg)
           if cfg.pred_normal else torch.zeros((p_sur.shape[0], 1),
                                               device=p_sur.device))
    return feat, phi, local_tbn


def sample_patches(field_params, state: MeshFieldState, cfg: MeshFieldConfig,
                   mesh: Mesh, scfg: PatchSampleConfig, *,
                   scan_pcl: np.ndarray | None = None,
                   mesh_for_sample: Mesh | None = None,
                   direction_points: np.ndarray | None = None,
                   face_subset: np.ndarray | None = None,
                   stats: dict | None = None) -> dict:
    """Export patches of the field ``field_params`` (the curved params'
    'field' entry) on ``state.projector``'s device.

    Returns the field-export dict (numpy): patches [n, ps, ps, L * C],
    grid_gap, patch_coors [n, ps, ps, 3] (the hits), patch_norms [n, 3],
    patch_sample_tbn [n, 9], patch_local_tbn [n, ps, ps, 9],
    picked_vertices [n, 3] (the centres), patch_phi_embed
    [n, ps, ps, P], patch_rays (with ``record_rays``), mesh_vertices,
    mesh_faces.  ``face_subset`` restricts the centres to those faces of
    the sampling mesh.  ``stats``, if given, receives the candidate
    centres and the rays cast."""
    mfs = mesh_for_sample if mesh_for_sample is not None else mesh
    grid_gap = mfs.mean_edge_length * scfg.pattern_rate
    ps = scfg.patch_size
    patch_len = ps * grid_gap
    scan_tree = cKDTree(scan_pcl) if scan_pcl is not None else None
    first = pca_first_component(
        direction_points if direction_points is not None
        else mesh.vertices)
    n_cand = max(scfg.max_patch_num,
                 int(np.ceil(scfg.max_patch_num * scfg.center_oversample)))
    centers = poisson_disk_sample(mfs, n_cand, scfg.seed,
                                  face_subset=face_subset)
    _, vidx = cKDTree(mfs.vertices).query(centers)
    v_normals = mfs.vertex_normals[vidx]
    # patch-local texel offsets, z = 0
    cal = np.linspace(-patch_len / 2, patch_len / 2, ps)
    gx, gy = np.meshgrid(cal, cal, indexing="ij")
    texels = np.stack([gx.ravel(), gy.ravel(), np.zeros(ps * ps)], -1)
    pa = state.projector
    device = pa.vertices.device

    out_patches, out_coors, out_norms = [], [], []
    out_stbn, out_ltbn, out_phi, out_centers, out_rays = [], [], [], [], []
    n_seen = n_rays = 0
    B = scfg.center_batch
    for start in range(0, len(centers), B):
        batch_c = centers[start:start + B]
        batch_n = v_normals[start:start + B]
        n_seen += len(batch_c)
        # below-y=0 rejection without a scan
        if scan_pcl is None:
            keep = batch_c[:, 1] >= 0
        else:
            keep = np.ones(len(batch_c), bool)
        # local frames aligned with the first principal component
        origins = np.zeros((len(batch_c), ps * ps, 3), np.float32)
        tbns = np.zeros((len(batch_c), 9), np.float32)
        for i, (c, z_axis) in enumerate(zip(batch_c, batch_n)):
            y_axis = np.cross(z_axis, first)
            if np.abs(y_axis).sum() < 1e-12:
                y_axis = np.cross(z_axis, np.array([1.0, 1.0, 1.01])
                                  * first)
            y_axis /= np.linalg.norm(y_axis)
            x_axis = np.cross(y_axis, z_axis)
            R = np.stack([x_axis, y_axis, z_axis], -1)
            origins[i] = texels @ R.T + c
            tbns[i] = R.T.reshape(9)
        if scan_tree is not None:
            bound = min(1e-1, scfg.scan_dist_factor * cfg.h_threshold)
            for i in range(len(batch_c)):
                d, _ = scan_tree.query(origins[i])
                if d.max() > bound:
                    keep[i] = False
        if not keep.any():
            continue
        ray_o = origins + 0.1 * batch_n[:, None, :]
        ray_d = np.broadcast_to(-batch_n[:, None, :], ray_o.shape)
        p_hit, _, depth, _ = raycast(
            pa.tgrid, pa.vertices, pa.faces,
            torch.as_tensor(ray_o.reshape(-1, 3), dtype=torch.float32,
                            device=device),
            torch.as_tensor(np.ascontiguousarray(ray_d).reshape(-1, 3),
                            dtype=torch.float32, device=device))
        n_rays += ray_o.shape[0] * ray_o.shape[1]
        depth = depth.reshape(len(batch_c), ps * ps).cpu().numpy()
        keep &= depth.max(-1) < 9.5           # every ray must hit
        if not keep.any():
            continue
        kept = np.where(keep)[0]
        p_hit = p_hit.reshape(len(batch_c), ps * ps, 3)[
            torch.as_tensor(kept, device=device)]
        feat, phi, ltbn = encode_texels(field_params, state, cfg,
                                        p_hit.reshape(-1, 3))
        feat = feat.reshape(len(kept), ps, ps, -1).cpu().numpy()
        phi = phi.reshape(len(kept), ps, ps, -1).cpu().numpy()
        ltbn = ltbn.reshape(len(kept), ps, ps, 9).cpu().numpy()
        p_hit = p_hit.reshape(len(kept), ps, ps, 3).cpu().numpy()
        for j, i in enumerate(kept):
            out_patches.append(feat[j])
            out_phi.append(phi[j])
            out_ltbn.append(ltbn[j])
            out_coors.append(p_hit[j])
            out_norms.append(batch_n[i])
            out_stbn.append(tbns[i])
            out_centers.append(batch_c[i])
            if scfg.record_rays:
                out_rays.append(np.concatenate(
                    [ray_o[i], ray_d[i]], -1).reshape(ps, ps, 6))
        if len(out_patches) >= scfg.max_patch_num:
            break
    if stats is not None:
        stats.update(candidates=n_seen, rays=n_rays)
    n = min(len(out_patches), scfg.max_patch_num)
    return {
        "patches": np.stack(out_patches[:n]) if n else np.zeros(
            (0, ps, ps, cfg.encoder_f_out_dim)),
        "grid_gap": grid_gap,
        "patch_coors": np.stack(out_coors[:n]) if n else None,
        "patch_norms": np.stack(out_norms[:n]) if n else None,
        "patch_sample_tbn": np.stack(out_stbn[:n]) if n else None,
        "patch_local_tbn": np.stack(out_ltbn[:n]) if n else None,
        "picked_vertices": np.stack(out_centers[:n]) if n else None,
        "patch_phi_embed": np.stack(out_phi[:n]) if n else None,
        "patch_rays": (np.stack(out_rays[:n])
                       if scfg.record_rays and n else None),
        "mesh_vertices": mesh.vertices,
        "mesh_faces": mesh.faces,
    }
