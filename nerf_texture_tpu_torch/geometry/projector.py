"""Mesh projector: the template mesh's device state and the anchor-frame
queries of the curved model (port of the serving-path part of
``nerf_texture_tpu/geometry/projector.py``).

``MeshProjector`` does the host work once per mesh (UV atlas, per-face
and per-vertex TBN frames, vertex and triangle grids) and holds the
result as a ``ProjectorArrays`` of tensors on one device.  The curved
field's chart at a point x is the tangent plane of an *anchor frame*
(p0, normal, tbn, hit): ``seed_anchor_frames`` computes it from the kNN
of a seed point, ``build_anchor_table`` evaluates it once at every
density-grid cell centre, and ``anchor_frames_from_table`` reads it back
with one row gather per point.

Not ported (each raises ``NotImplementedError`` naming ROADMAP Queue 1,
item 7): the exact per-sample projection (``project``, which casts rays)
and the queries built on it (``weighted_project``, ``uvh``,
``barycentric_mapping``, ``diff_project``).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .mesh import Mesh, calculate_tbn, uv_atlas
from .spatial import GridIndex, build_grid, build_triangle_grid, knn


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


def _normalize(v: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    return v / (torch.linalg.norm(v, dim=-1, keepdim=True) + eps)


def knn_normal(p: ProjectorArrays, xyz: torch.Tensor, *, k: int = 8,
               dir_vec_wdist: float = 0.05, stencil: str = "faces"):
    """Weighted-kNN normal estimate at xyz [Q, 3] with the JAX defaults
    (Shepard weights, the mean direction as a virtual neighbour; the
    7-cell stencil, ``stencil='full'`` for the 27-cell one).  The other
    weightings and vetoes of the JAX function serve the exact projection
    and come with it (ROADMAP Queue 1, item 7).

    Returns (normal [Q, 3], dir_vec_ori [Q, K, 3], indices [Q, K],
    dis [Q, K + 1])."""
    dis, idx = knn(p.vgrid, p.vertices, xyz, k=k, stencil=stencil)
    normals = p.vertex_normals[idx]                    # [Q, K, 3]
    dir_vec_ori = xyz[:, None, :] - p.vertices[idx]
    dir_vec = _normalize(dir_vec_ori)
    # the inverse-distance-weighted mean direction joins as an extra
    # "virtual neighbour normal"
    mean_dir = torch.sum((1.0 / (dis + 1e-7))[..., None] * dir_vec, dim=1,
                         keepdim=True)
    normal_test = torch.mean(normals, dim=1, keepdim=True)
    flip = torch.sum(mean_dir * normal_test, dim=-1, keepdim=True) < 0
    mean_dir = _normalize(torch.where(flip, -mean_dir, mean_dir))
    normals = torch.cat([normals, mean_dir], dim=1)
    dis = torch.cat([dis, torch.full_like(dis[:, :1],
                                          max(dir_vec_wdist, 1e-5))], dim=1)
    weights = 1.0 / (dis + 1e-7)                       # Shepard
    # degenerate all-zero weights -> uniform
    wsum = torch.sum(weights, dim=-1, keepdim=True)
    weights = torch.where(wsum > 1e-12, weights / (wsum + 1e-12),
                          1.0 / weights.shape[-1])
    normal = _normalize(torch.sum(_normalize(normals) * weights[..., None],
                                  dim=-2))
    return normal, dir_vec_ori, idx, dis


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
    from scipy.spatial import cKDTree

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


def _not_ported(name: str):
    def fn(*args, **kwargs):
        raise NotImplementedError(
            f"projector.{name}: the exact per-sample projection and the "
            f"queries built on it are not ported; ROADMAP Queue 1, item 7")
    fn.__name__ = name
    return fn


project = _not_ported("project")
weighted_project = _not_ported("weighted_project")
uvh = _not_ported("uvh")
barycentric_mapping = _not_ported("barycentric_mapping")
diff_project = _not_ported("diff_project")
