"""Mesh projector: the template mesh's device state and the queries that
map points to the surface (port of
``nerf_texture_tpu/geometry/projector.py``).

``MeshProjector`` does the host work once per mesh (UV atlas, per-face
and per-vertex TBN frames, vertex and triangle grids) and holds the
result as a ``ProjectorArrays`` of tensors on one device.

Two families of queries run over it:

- anchor frames, the curved model's fast path: the chart at a point x is
  the tangent plane of an anchor frame (p0, normal, tbn, hit);
  ``seed_anchor_frames`` computes it from the kNN of a seed point,
  ``build_anchor_table`` evaluates it once at every density-grid cell
  centre, and ``anchor_frames_from_table`` reads it back with one row
  gather per point;
- the exact projection: ``project`` casts the +-normal rays of the kNN
  normal estimate (``spatial.raycast``) and keeps the nearer hit;
  ``barycentric_mapping``, ``uvh`` and ``query_tbn`` read the hit face;
  ``weighted_project`` is the kNN-weighted height without a cast (the
  patch import's); ``signed_distance`` the nearest-face query signed by
  the kNN normal.  ``diff_project`` routes the gradients of the surface
  point and the height back into the query point.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch
from scipy.spatial import cKDTree

from .mesh import Mesh, calculate_tbn, uv_atlas
from .spatial import (GridIndex, build_grid, build_triangle_grid, knn,
                      nearest_face, raycast)

DEPTH_THRESHOLD = 9.5  # the ray cast's miss marker (depth 10)


class ProjectorArrays(NamedTuple):
    """Mesh + spatial index state on one device."""

    vertices: torch.Tensor        # [V, 3] f32
    vertex_normals: torch.Tensor  # [V, 3] f32
    faces: torch.Tensor           # [F, 3] int64
    face_tbn: torch.Tensor        # [F, 3, 3] f32 rows (T, B, N)
    uvs: torch.Tensor             # [V, 2] f32 in [-1, 1]
    vgrid: GridIndex
    tgrid: GridIndex
    vertex_tbn: torch.Tensor | None = None  # [V, 3, 3] an incident face's


class MeshProjector:
    """Host facade: builds the device state of ``mesh`` once.

    A UV atlas is computed when the mesh has none (``store_uv``); the
    per-vertex TBN is that of the lowest-indexed incident face (the
    kNN-seeded anchor frames have no face hit)."""

    def __init__(self, mesh: Mesh, *, grid_res: int | None = None,
                 max_per_cell: int = 16, tri_max_per_cell: int = 24,
                 store_uv: bool = True,
                 device: torch.device | str = "cuda"):
        if store_uv and mesh.uvs is None:
            mesh = uv_atlas(mesh)
        self.mesh = mesh
        self.device = torch.device(device)
        self.mean_edge_length = mesh.mean_edge_length
        self.gaussian_factor = -1.0 / (self.mean_edge_length ** 2 + 1e-20)
        if store_uv:
            uvs = mesh.uvs
            uvs = (uvs - uvs.min()) / (uvs.max() - uvs.min() + 1e-20) \
                * 2.0 - 1.0                     # [-1, 1]
            tbn = calculate_tbn(mesh, uvs)
        else:
            uvs = np.zeros((len(mesh.vertices), 2))
            tbn = np.repeat(np.eye(3)[None], len(mesh.faces), axis=0)
        if grid_res is None:
            grid_res = int(np.clip(round(len(mesh.vertices) ** (1 / 3) * 2),
                                   8, 64))
        # mean 3D edge length / mean UV edge length
        e = mesh.edges_unique
        uv_len = np.linalg.norm(uvs[e[:, 0]] - uvs[e[:, 1]], axis=-1)
        self.recommended_sdf_factor = self.mean_edge_length / max(
            uv_len.mean(), 1e-9)
        faces_np = np.asarray(mesh.faces)
        vf = np.full(len(mesh.vertices), len(faces_np), np.int64)
        fid = np.arange(len(faces_np))
        for c in range(3):
            np.minimum.at(vf, faces_np[:, c], fid)
        vertex_tbn = tbn[np.clip(vf, 0, len(faces_np) - 1)]

        def f32(a):
            return torch.as_tensor(np.asarray(a, np.float32),
                                   device=self.device)

        self.arrays = ProjectorArrays(
            vertices=f32(mesh.vertices),
            vertex_normals=f32(mesh.vertex_normals),
            faces=torch.as_tensor(faces_np, dtype=torch.int64,
                                  device=self.device),
            face_tbn=f32(tbn),
            uvs=f32(uvs),
            vgrid=build_grid(mesh.vertices, grid_res, max_per_cell,
                             device=self.device),
            tgrid=build_triangle_grid(mesh.vertices, mesh.faces, grid_res,
                                      tri_max_per_cell, device=self.device),
            vertex_tbn=f32(vertex_tbn))

    @functools.cached_property
    def vertex_tree(self) -> cKDTree:
        """A cKDTree of the mesh's vertices (host, f64), built on first
        use."""
        return cKDTree(self.mesh.vertices)


def _normalize(v: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    return v / (torch.linalg.norm(v, dim=-1, keepdim=True) + eps)


def knn_normal(p: ProjectorArrays, xyz: torch.Tensor, *, k: int = 8,
               gaussian_factor: float = -1.0, use_dir_vec: bool = True,
               dir_vec_wdist: float = 0.05, weighting: str = "Shepard",
               nn_consis_check: bool = False,
               direct_above_check: bool = False,
               direct_above_threshold: float = 1e-1,
               stencil: str = "faces"):
    """Weighted-kNN normal estimate at xyz [Q, 3] (the 7-cell stencil by
    default, ``stencil='full'`` for the 27-cell one).

    ``nn_consis_check`` vetoes the neighbours whose direction to the
    query points away from the nearest one's; ``direct_above_check``
    vetoes queries that lie above no neighbour (distance 1e5);
    ``use_dir_vec`` appends the inverse-distance-weighted mean direction
    as a virtual neighbour normal at distance ``dir_vec_wdist``.  The
    weights are ``weighting``: 'Shepard' (inverse distance), 'Gaussian'
    (exp(dis * gaussian_factor)) or 'DualD'; all-zero weights turn
    uniform.

    Returns (normal [Q, 3], dir_vec_ori [Q, K, 3], indices [Q, K],
    dis [Q, K] or [Q, K + 1] with ``use_dir_vec``)."""
    dis, idx = knn(p.vgrid, p.vertices, xyz, k=k, stencil=stencil)
    normals = p.vertex_normals[idx]                    # [Q, K, 3]
    dir_vec_ori = xyz[:, None, :] - p.vertices[idx]
    dir_vec = _normalize(dir_vec_ori)
    if nn_consis_check:
        # >= 0: a query on a vertex has a zero first direction, which
        # must not veto every neighbour
        cos = torch.sum(dir_vec * dir_vec[:, :1, :], dim=-1)
        dis = torch.where(cos >= 0, dis, 1e5)
    if direct_above_check:
        p2n = 2.0 * torch.amin(torch.linalg.norm(
            torch.linalg.cross(normals, dir_vec), dim=-1), dim=-1)
        above = (p2n < direct_above_threshold)[:, None]
        dis = torch.where(above, dis, 1e5)
        dir_vec_ori = torch.where(above[..., None], dir_vec_ori, 1e5)
    if use_dir_vec:
        mean_dir = torch.sum((1.0 / (dis + 1e-7))[..., None] * dir_vec,
                             dim=1, keepdim=True)
        normal_test = torch.mean(normals, dim=1, keepdim=True)
        flip = torch.sum(mean_dir * normal_test, dim=-1, keepdim=True) < 0
        mean_dir = _normalize(torch.where(flip, -mean_dir, mean_dir))
        normals = torch.cat([normals, mean_dir], dim=1)
        dis = torch.cat([dis, torch.full_like(dis[:, :1],
                                              max(dir_vec_wdist, 1e-5))],
                        dim=1)
    weights = _weights(dis, weighting, gaussian_factor, 1e-7)
    wsum = torch.sum(weights, dim=-1, keepdim=True)
    weights = torch.where(wsum > 1e-12, weights / (wsum + 1e-12),
                          1.0 / weights.shape[-1])
    normal = _normalize(torch.sum(_normalize(normals) * weights[..., None],
                                  dim=-2))
    return normal, dir_vec_ori, idx, dis


def _weights(dis: torch.Tensor, weighting: str, gaussian_factor: float,
             shepard_eps: float) -> torch.Tensor:
    """Unnormalised neighbour weights of distances dis [Q, K]."""
    if weighting == "Gaussian":
        return torch.exp(dis * gaussian_factor)
    if weighting == "Shepard":
        return 1.0 / (dis + shepard_eps)
    if weighting == "DualD":
        dk = torch.amax(dis, dim=-1, keepdim=True)
        d1 = torch.amin(dis, dim=-1, keepdim=True)
        return (dk - dis) / (dk - d1 + 1e-5) * (dk + d1) / (dk + dis)
    raise ValueError(f"unknown weighting {weighting}")


def seed_anchor_frames(p: ProjectorArrays, x_seed: torch.Tensor,
                       seed_valid: torch.Tensor, *, k: int = 8,
                       max_dist: float = math.inf):
    """Anchor frames without ray casting: the weighted kNN projection of
    each seed point x_seed [N, 3] onto the mesh.

    seed_valid [N] bool marks the points that have a seed; ``max_dist``
    gates the nearest-vertex distance.  Returns dict(p0 [N, 3],
    normal [N, 3], tbn [N, 3, 3], hit [N] bool)."""
    x_seed = x_seed.detach()
    normal, dir_vec, idx, dis = knn_normal(p, x_seed, k=k)
    sdfs = torch.sum(dir_vec * normal[:, None, :], dim=-1)      # [Q, K]
    perp = dir_vec - sdfs[..., None] * normal[:, None, :]
    dist2d = torch.linalg.norm(perp, dim=-1)
    dk = torch.amax(dist2d, dim=-1, keepdim=True)
    d1 = torch.amin(dist2d, dim=-1, keepdim=True)
    w = (dk - dist2d) / (dk - d1 + 1e-5) * (dk + d1) / (dk + dist2d)
    w = w / (torch.sum(w, dim=-1, keepdim=True) + 1e-5)
    h = torch.sum(sdfs * w, dim=-1, keepdim=True)
    p0 = x_seed - h * normal
    if p.vertex_tbn is not None:
        tbn = p.vertex_tbn[idx[:, 0]]
    else:
        tbn = torch.eye(3, device=x_seed.device).expand(idx.shape[0], 3, 3)
    hit = seed_valid & (torch.amin(dis[:, :k], dim=-1) < max_dist)
    return {"p0": p0, "normal": normal, "tbn": tbn, "hit": hit}


def _frame_rows(f) -> torch.Tensor:
    """[N, 16] rows p0[3] normal[3] tbn[9 row-major] hit[1]."""
    return torch.cat([f["p0"], f["normal"], f["tbn"].reshape(-1, 9),
                      f["hit"][:, None].to(torch.float32)], dim=-1)


@torch.no_grad()
def build_anchor_table(p: ProjectorArrays, grid_size: int, bound: float,
                       *, k: int = 8, max_dist: float, chunk: int = 131072,
                       collapse_columns: bool = True) -> torch.Tensor:
    """[H, H, H, 16] anchor frames at every grid-cell centre (rows as
    ``_frame_rows``), on the projector's device.

    Cells farther than ``max_dist`` from every vertex (a host cKDTree
    prefilter; the hit gate is that same distance test) are skipped and
    keep a SAFE identity row -- their own centre, +z normal, identity
    TBN, hit 0 -- not zeros: a zero normal reaches a normalisation whose
    gradient at exactly 0 is NaN.

    collapse_columns: every cell adopts the row of its SURFACE cell (the
    cell holding its own anchor's p0), so the cells stacked along a
    normal column share one tangent chart; a cell stays usable only if
    both it and its surface cell pass the distance gate."""
    H = grid_size
    device = p.vertices.device
    centers = ((np.stack(np.meshgrid(*([np.arange(H)] * 3),
                                     indexing="ij"), -1)
                .reshape(-1, 3) + 0.5) / H * 2.0 - 1.0) * bound
    n = centers.shape[0]
    rows = np.zeros((n, 16), np.float32)
    rows[:, 0:3] = centers
    rows[:, 5] = 1.0                                   # normal = +z
    rows[:, 6] = rows[:, 10] = rows[:, 14] = 1.0       # tbn = I
    d, _ = cKDTree(p.vertices.cpu().numpy()).query(centers, workers=-1)
    near = np.where(d < max_dist)[0]
    sel = torch.as_tensor(centers[near].astype(np.float32), device=device)
    out = []
    for start in range(0, len(near), chunk):
        pts = sel[start:start + chunk]
        valid = torch.ones(pts.shape[0], dtype=torch.bool, device=device)
        out.append(_frame_rows(seed_anchor_frames(p, pts, valid, k=k,
                                                  max_dist=max_dist)))
    if out:
        rows[near] = torch.cat(out).cpu().numpy()
    if collapse_columns:
        cell = np.clip(((rows[:, 0:3] + bound) * (H / (2.0 * bound)))
                       .astype(np.int64), 0, H - 1)
        surf = (cell[:, 0] * H + cell[:, 1]) * H + cell[:, 2]
        hit = rows[:, 15:16].copy()
        rows = rows[surf]
        rows[:, 15:16] = np.minimum(rows[:, 15:16], hit)
    return torch.as_tensor(rows.reshape(H, H, H, 16), device=device)


def anchor_frames_from_table(table: torch.Tensor, x_seed: torch.Tensor,
                             seed_valid: torch.Tensor, bound: float):
    """Frames of points x_seed [N, 3] in [-bound, bound] by one row gather
    from ``build_anchor_table``'s table (the cell index truncates toward
    zero, as the JAX ``astype(int32)``)."""
    H = table.shape[0]
    cell = torch.clamp(((x_seed + bound) * (H / (2.0 * bound)))
                       .to(torch.int32), 0, H - 1).to(torch.int64)
    flat = (cell[..., 0] * H + cell[..., 1]) * H + cell[..., 2]
    rows = table.reshape(-1, 16)[flat]                          # [N, 16]
    return {"p0": rows[:, 0:3], "normal": rows[:, 3:6],
            "tbn": rows[:, 6:15].reshape(-1, 3, 3),
            "hit": seed_valid & (rows[:, 15] > 0.5)}


# ---------------------------------------------------------------------------
# the exact projection
# ---------------------------------------------------------------------------

def pointcloud_arrays(points: np.ndarray, normals: np.ndarray, *,
                      grid_res: int | None = None, max_per_cell: int = 32,
                      device: torch.device | str = "cuda"
                      ) -> ProjectorArrays:
    """ProjectorArrays of a bare point cloud [N, 3] with normals [N, 3],
    for kNN queries only (the patch import): faces, TBNs, uvs and the
    triangle grid are one-element placeholders."""
    if grid_res is None:
        grid_res = int(np.clip(round(len(points) ** (1 / 3) * 2), 8, 64))
    dummy_tri = build_triangle_grid(points[:3] if len(points) >= 3
                                    else np.zeros((3, 3)),
                                    np.asarray([[0, 1, 2]]), 2, 4,
                                    device=device)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return ProjectorArrays(
        vertices=f32(points), vertex_normals=f32(normals),
        faces=torch.zeros((1, 3), dtype=torch.int64, device=device),
        face_tbn=f32(np.eye(3)[None]), uvs=f32(np.zeros((len(points), 2))),
        vgrid=build_grid(points, grid_res, max_per_cell, device=device),
        tgrid=dummy_tri,
        vertex_tbn=f32(np.broadcast_to(np.eye(3), (len(points), 3, 3))))


def _cast_both_ways(p: ProjectorArrays, xyz, normal, cast_steps: int):
    """Cast +normal and -normal from xyz and keep the nearer hit:
    (p_sur [Q, 3], signed height [Q, 1] (negative on the inner side),
    face index [Q])."""
    p1, _, d1, f1 = raycast(p.tgrid, p.vertices, p.faces, xyz, normal,
                            max_steps=cast_steps)
    p2, _, d2, f2 = raycast(p.tgrid, p.vertices, p.faces, xyz, -normal,
                            max_steps=cast_steps)
    cond = d1 < d2
    return (torch.where(cond[:, None], p1, p2),
            torch.where(cond, -d1, d2)[:, None], torch.where(cond, f1, f2))


def project(p: ProjectorArrays, xyz: torch.Tensor, *, k: int = 8,
            h_threshold: float | None = None,
            requires_grad_xyz: bool = False, cast_steps: int = 12):
    """Project xyz [Q, 3] to the surface along the kNN normal estimate:
    cast the +-normal rays (a walk of ``cast_steps`` cells: the queries
    lie near the surface), keep the nearer hit.

    Returns (p_sur [Q, 3], sdf [Q, 1], h_mask [Q], normal [Q, 3],
    tbn [Q, 3, 3]); with ``requires_grad_xyz`` the outputs carry
    ``diff_project``'s gradients into xyz."""
    xyz_in = xyz
    xyz = xyz.detach()
    normal, _, _, _ = knn_normal(p, xyz, k=k)
    p_sur, sdf, face_idx = _cast_both_ways(p, xyz, normal, cast_steps)
    tbn = p.face_tbn[torch.clamp(face_idx, min=0)]
    ht = math.inf if h_threshold is None else h_threshold
    h_mask = torch.abs(sdf[:, 0]) < min(DEPTH_THRESHOLD, ht)
    if requires_grad_xyz:
        _, p_sur, sdf, normal = diff_project(xyz_in, p_sur, sdf, normal)
    return p_sur, sdf, h_mask, normal, tbn


def ray_anchor_frames(p: ProjectorArrays, rays_o: torch.Tensor,
                      rays_d: torch.Tensor, *, k: int = 8,
                      cast_steps: int = 64):
    """Per-ray anchor frames by one cast of each ray against the mesh:
    dict(p0 [N, 3] the hit, normal [N, 3] the kNN normal there, tbn
    [N, 3, 3] the hit face's, hit [N] bool)."""
    pos, _, depth, fid = raycast(p.tgrid, p.vertices, p.faces, rays_o,
                                 rays_d, max_steps=cast_steps)
    normal, _, _, _ = knn_normal(p, pos, k=k)
    return {"p0": pos, "normal": normal,
            "tbn": p.face_tbn[torch.clamp(fid, min=0)],
            "hit": depth < DEPTH_THRESHOLD}


def weighted_project(p: ProjectorArrays, xyz: torch.Tensor, *, k: int = 8,
                     weighting: str = "DualD", sdf_scale: float = 1.0,
                     sdf_offset: float = 0.0, return_psur: bool = False,
                     gaussian_factor: float = -1.0,
                     direct_above_check: bool = False,
                     direct_above_threshold: float = 1e-1):
    """kNN-weighted signed height without a ray cast: each neighbour's
    height along the estimated normal, weighted by its distance in the
    tangent plane.

    Returns (sdf [Q, 1], idx [Q, K], weights [Q, K], normal [Q, 3],
    dis [Q, K]), or with ``return_psur`` (sdf, p_sur, normal)."""
    normal, dir_vec, idx, dis = knn_normal(
        p, xyz, k=k, use_dir_vec=False, gaussian_factor=gaussian_factor,
        direct_above_check=direct_above_check,
        direct_above_threshold=direct_above_threshold)
    sdfs = torch.sum(dir_vec * normal[:, None, :], dim=-1)      # [Q, K]
    perp = dir_vec - sdfs[..., None] * normal[:, None, :]
    dist2d = torch.linalg.norm(perp, dim=-1)                    # [Q, K]
    weights = _weights(dist2d, weighting, gaussian_factor, 1e-5)
    weights = weights / (torch.sum(weights, dim=-1, keepdim=True) + 1e-5)
    sdf = torch.sum(sdfs * weights, dim=-1, keepdim=True) \
        / max(1e-5, sdf_scale) - sdf_offset
    if return_psur:
        return sdf, xyz - sdf * normal, normal
    return sdf, idx, weights, normal, dis


def barycentric_mapping(p: ProjectorArrays, xyz: torch.Tensor,
                        normal: torch.Tensor, *,
                        h_threshold: float | None = None,
                        sdf_scale: float = 1.0, sdf_offset: float = 0.0,
                        requires_grad_xyz: bool = False,
                        cast_steps: int = 12):
    """Project xyz [Q, 3] along +-normal [Q, 3] and return the hit face's
    vertex ids [Q, 3], the barycentrics of the hit [Q, 3], the scaled
    signed height [Q, 1], h_mask [Q] (a hit within the threshold) and the
    face index [Q]."""
    from .triangle import points_to_barycentric

    xyz_in = xyz
    xyz = xyz.detach()
    p_sur, sdf, face_idx = _cast_both_ways(p, xyz, normal, cast_steps)
    sdf = sdf / max(1e-5, sdf_scale) - sdf_offset
    if requires_grad_xyz:
        normal_est, _, _, _ = knn_normal(p, xyz, k=8)
        _, p_sur, sdf, _ = diff_project(xyz_in, p_sur, sdf, normal_est)
    ht = math.inf if h_threshold is None else h_threshold
    h_mask = (torch.abs(sdf[:, 0]) < min(DEPTH_THRESHOLD, ht)) \
        & (face_idx >= 0)
    vertex_idx = p.faces[torch.clamp(face_idx, min=0)]           # [Q, 3]
    bary = points_to_barycentric(p.vertices[vertex_idx], p_sur)
    return vertex_idx, bary, sdf, h_mask, face_idx


def query_tbn(p: ProjectorArrays, xyz: torch.Tensor, *, k: int = 8,
              h_threshold: float | None = None, sdf_scale: float = 1.0,
              sdf_offset: float = 0.0):
    """The TBN frame [Q, 3, 3] of the face each point projects onto, and
    h_mask [Q]."""
    normal, _, _, _ = knn_normal(p, xyz, k=k, use_dir_vec=False,
                                 weighting="DualD", nn_consis_check=True)
    _, _, _, h_mask, face_idx = barycentric_mapping(
        p, xyz, normal, h_threshold=h_threshold, sdf_scale=sdf_scale,
        sdf_offset=sdf_offset)
    return p.face_tbn[torch.clamp(face_idx, min=0)], h_mask


def uvh(p: ProjectorArrays, xyz: torch.Tensor, *, k: int = 8,
        h_threshold: float | None = None, sdf_scale: float = 1.0,
        sdf_offset: float = 0.0, requires_grad_xyz: bool = False,
        normal: torch.Tensor | None = None):
    """(u, v, signed height) [Q, 3] of each point: the uv of its
    projection by barycentric interpolation of the hit face; also
    h_mask [Q], the normal [Q, 3] and the hit face's TBN [Q, 3, 3]."""
    if normal is None:
        normal, _, _, _ = knn_normal(p, xyz, k=k, use_dir_vec=False,
                                     weighting="DualD", nn_consis_check=True)
    vertex_idx, bary, sdf, h_mask, face_idx = barycentric_mapping(
        p, xyz, normal, h_threshold=h_threshold, sdf_scale=sdf_scale,
        sdf_offset=sdf_offset, requires_grad_xyz=requires_grad_xyz)
    uv = torch.sum(p.uvs[vertex_idx] * bary[..., None], dim=-2)
    return (torch.cat([uv, sdf], dim=-1), h_mask, normal,
            p.face_tbn[torch.clamp(face_idx, min=0)])


def signed_distance(p: ProjectorArrays, xyz: torch.Tensor, *, k: int = 8):
    """Nearest-surface query: (sdf [Q], face index [Q], barycentric
    [Q, 3], closest point [Q, 3]), signed positive on the side the kNN
    normal points to."""
    udf, fid, bary, closest = nearest_face(p.tgrid, p.vertices, p.faces,
                                           xyz)
    normal, _, _, _ = knn_normal(p, xyz, k=k, use_dir_vec=False,
                                 weighting="DualD")
    outside = torch.sum((xyz - closest) * normal, dim=-1) >= 0
    return torch.where(outside, udf, -udf), fid, bary, closest


class _DiffProject(torch.autograd.Function):
    """Identity forward; the backward routes the surface point's gradient
    tangentially and the height's along the normal into xyz."""

    @staticmethod
    def forward(ctx, xyz, p_sur, sdf, normal):
        ctx.save_for_backward(normal)
        return (xyz.view_as(xyz), p_sur.view_as(p_sur), sdf.view_as(sdf),
                normal.view_as(normal))

    @staticmethod
    def backward(ctx, g_xyz, g_psur, g_sdf, g_normal):
        (normal,) = ctx.saved_tensors
        n = _normalize(normal)
        tangential = g_psur - n * torch.sum(n * g_psur, dim=-1, keepdim=True)
        return g_xyz + tangential + g_sdf * n, g_psur, g_sdf, g_normal


def diff_project(xyz, p_sur, sdf, normal):
    """(xyz, p_sur, sdf, normal) unchanged, with the projection's
    gradient: d p_sur / d xyz is the tangential projection and
    d sdf / d xyz the normal."""
    return _DiffProject.apply(xyz, p_sur, sdf, normal)
