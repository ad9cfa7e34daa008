"""Grid-hash spatial index (port of ``nerf_texture_tpu/geometry/spatial.py``,
the part the curved serving path runs).

One uniform voxel index over the mesh's items (vertices or triangles),
built once per mesh as padded fixed-width tables on the device; a query
gathers the candidate ids of the cells around a point plus a per-cell
fallback list (the items nearest to the cell centre, so a far query
still gets real candidates) and picks among them with tensor math.

Three queries run over the index: ``knn`` (vertices around a point),
``raycast`` (the first triangle hit along a ray, a 3D-DDA voxel walk of
every ray in lockstep, testing each visited cell's triangles) and
``nearest_face`` (the closest triangle to a point among its candidates).

The tables are built on the device the caller names, by ``native``
(the port of the JAX package's ``native.py``): on the card by the
hand-written kernels of ``csrc/spatial_build.cu``, on the CPU by their
plain versions.  The cell lists equal the JAX package's C++ builder's
bit for bit (cells found in float32, lowest ids first), and so do the
fallback lists: cKDTree is built on the host from the same items, and
the card runs its query step for step (``native.kdtree``,
``native.build_fallback``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import native
from .triangle import _closest_weights


class GridIndex(NamedTuple):
    """Device tables of a voxel index over items."""

    cell_items: torch.Tensor   # [R**3, M] int64 item ids, -1 padded
    fallback: torch.Tensor     # [R**3, F] int64 nearest item ids to centre
    origin: torch.Tensor       # [3] f32 grid origin
    cell_size: torch.Tensor    # [] f32
    res: int                   # resolution


def _cell_of(points, origin, cell_size, res: int):
    c = torch.floor((points - origin) / cell_size).to(torch.int64)
    return torch.clamp(c, 0, res - 1)


def _flat(c, res: int):
    return (c[..., 0] * res + c[..., 1]) * res + c[..., 2]


def _index(cell_items, fallback, lo, cell_size, res, device) -> GridIndex:
    return GridIndex(
        cell_items=torch.as_tensor(cell_items, dtype=torch.int64,
                                   device=device),
        fallback=torch.as_tensor(fallback, dtype=torch.int64, device=device),
        origin=torch.as_tensor(np.asarray(lo, np.float32), device=device),
        cell_size=torch.tensor(cell_size, dtype=torch.float32,
                               device=device),
        res=res)


def build_grid(points_per_item: np.ndarray, res: int, max_per_cell: int,
               n_fallback: int = 8, aabb_pad: float = 1e-3,
               device: torch.device | str = "cuda") -> GridIndex:
    """Index items by one representative point each ([N, 3]): every cell
    lists up to ``max_per_cell`` of its items, lowest ids first.  The
    tables are built on ``device``."""
    pts = np.asarray(points_per_item, np.float64)
    lo = pts.min(0) - aabb_pad
    hi = pts.max(0) + aabb_pad
    cell_size = float((hi - lo).max() / res)
    cell_items = native.build_vertex_grid(torch.as_tensor(pts, device=device),
                                          res, lo, cell_size, max_per_cell)
    fallback = native.build_fallback(native.kdtree(pts, device), res, lo,
                                     cell_size, n_fallback)
    return _index(cell_items, fallback, lo, cell_size, res, device)


def build_triangle_grid(vertices: np.ndarray, faces: np.ndarray, res: int,
                        max_per_cell: int, n_fallback: int = 8,
                        device: torch.device | str = "cuda") -> GridIndex:
    """Bin triangles into every cell their AABB overlaps (conservative);
    the fallback lists hold the triangles nearest by centroid.  The
    tables are built on ``device``."""
    v = np.asarray(vertices, np.float64)
    f = np.asarray(faces, np.int64)
    corners = v[f.reshape(-1)]
    lo = corners.min(0) - 1e-3
    hi = corners.max(0) + 1e-3
    cell_size = float((hi - lo).max() / res)
    vt = torch.as_tensor(v, device=device)
    ft = torch.as_tensor(f, device=device)
    cell_items = native.build_triangle_grid(vt, ft, res, lo, cell_size,
                                            max_per_cell)
    # the centroids on the host, as the JAX package takes them: cKDTree
    # is built there
    fallback = native.build_fallback(
        native.kdtree(corners.reshape(-1, 3, 3).mean(1), device), res, lo,
        cell_size, n_fallback)
    return _index(cell_items, fallback, lo, cell_size, res, device)


_NEIGH = np.stack(np.meshgrid([-1, 0, 1], [-1, 0, 1], [-1, 0, 1],
                              indexing="ij"), -1).reshape(27, 3)
# centre + 6 face neighbours: 3.5x fewer candidates, approximate near
# cell corners (the fallback list still guarantees real candidates)
_NEIGH7 = np.asarray([[0, 0, 0], [1, 0, 0], [-1, 0, 0], [0, 1, 0],
                      [0, -1, 0], [0, 0, 1], [0, 0, -1]])


def gather_candidates(grid: GridIndex, points: torch.Tensor,
                      stencil: str = "full") -> torch.Tensor:
    """[Q, S*M + F] candidate item ids (-1 padded) around each point:
    'full' = the 27-cell neighbourhood, 'faces' = the 7-cell stencil."""
    c = _cell_of(points, grid.origin, grid.cell_size, grid.res)  # [Q, 3]
    off = torch.as_tensor(_NEIGH if stencil == "full" else _NEIGH7,
                          device=points.device)
    nb = torch.clamp(c[:, None, :] + off[None], 0, grid.res - 1)
    neigh = grid.cell_items[_flat(nb, grid.res)].reshape(points.shape[0], -1)
    fb = grid.fallback[_flat(c, grid.res)]
    return torch.cat([neigh, fb], dim=-1)


def knn(grid: GridIndex, vertices: torch.Tensor, points: torch.Tensor,
        k: int = 8, stencil: str = "full"):
    """k nearest vertices of each query point among its candidates.

    Returns (dists [Q, k], idx [Q, k] int64), nearest first.  Candidates
    are sorted by id, repeated ids and padding get distance^2 1e9, and a
    stable sort by distance keeps the lower id among equal distances --
    the order ``lax.top_k`` gives the JAX function."""
    cand = gather_candidates(grid, points, stencil)          # [Q, C]
    s_keys, _ = torch.sort(cand, dim=-1)
    safe = torch.clamp(s_keys, min=0)
    d2 = ((vertices[:, 0][safe] - points[:, 0:1]) ** 2
          + (vertices[:, 1][safe] - points[:, 1:2]) ** 2
          + (vertices[:, 2][safe] - points[:, 2:3]) ** 2)
    dup = torch.cat([torch.zeros_like(s_keys[:, :1], dtype=torch.bool),
                     s_keys[:, 1:] == s_keys[:, :-1]], dim=-1)
    d2 = torch.where(dup | (s_keys < 0), 1e9, d2)
    d2_k, order = torch.sort(d2, dim=-1, stable=True)
    idx = torch.gather(s_keys, 1, order[:, :k])
    return torch.sqrt(torch.clamp(d2_k[:, :k], min=0.0)), \
        torch.clamp(idx, min=0)


def _split3(a: torch.Tensor):
    """The three columns of a [N, 3] tensor, each contiguous (a gather
    from a strided column is many times slower)."""
    return tuple(a[:, i].contiguous() for i in range(3))


def _triangle_soa(vertices: torch.Tensor, faces: torch.Tensor):
    """Nine [F] coordinate arrays (ax..cz) of the face triangles."""
    return (_split3(vertices[faces[:, 0]]) + _split3(vertices[faces[:, 1]])
            + _split3(vertices[faces[:, 2]]))


def _mt_soa(o_soa, d_soa, tri_soa, idx: torch.Tensor, eps: float = 1e-9):
    """Moller-Trumbore of rays (per-axis [Q] origins and directions)
    against the faces idx [Q, M].  Returns (t [Q, M], hit [Q, M]); a hit
    at t >= -1e-5 counts (a point on the surface must register its t ~ 0
    hit) and reports max(t, 0)."""
    ox, oy, oz = (c[:, None] for c in o_soa)
    dx, dy, dz = (c[:, None] for c in d_soa)
    ax, ay, az, bx, by, bz, cx, cy, cz = (c[idx] for c in tri_soa)
    e1x, e1y, e1z = bx - ax, by - ay, bz - az
    e2x, e2y, e2z = cx - ax, cy - ay, cz - az
    px = dy * e2z - dz * e2y                      # pvec = d x e2
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    inv_det = torch.where(torch.abs(det) > eps, 1.0 / det, 0.0)
    tx, ty, tz = ox - ax, oy - ay, oz - az
    u = (tx * px + ty * py + tz * pz) * inv_det
    qx = ty * e1z - tz * e1y                      # qvec = tvec x e1
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    hit = ((torch.abs(det) > eps) & (u >= -eps) & (v >= -eps)
           & (u + v <= 1.0 + eps) & (t >= -1e-5))
    return torch.where(hit, torch.clamp(t, min=0.0), torch.inf), hit


def _face_normals(vertices: torch.Tensor, faces: torch.Tensor):
    tri = vertices[faces]
    n = torch.linalg.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    return n / (torch.linalg.norm(n, dim=-1, keepdim=True) + 1e-12)


SYNC_STEPS = 8    # the ray cast's steps between tests for an active ray


@torch.no_grad()
def raycast(grid: GridIndex, vertices: torch.Tensor, faces: torch.Tensor,
            rays_o: torch.Tensor, rays_d: torch.Tensor, *,
            max_steps: int = 64, miss_depth: float = 10.0):
    """First hit of rays_o / rays_d [Q, 3] on the mesh, by a 3D-DDA walk
    through the triangle grid: every iteration tests the current cell's
    triangle list of every ray, and a hit counts once it lies within
    the cell's t range (a nearer triangle of a later cell could not beat
    it).  Iterations are masked: an inactive ray never updates its hit.
    Like the JAX function's while-loop, the walk stops early once no ray
    is active, tested every ``SYNC_STEPS`` steps (one host sync each):
    the patch export's rays hit within a few cells, and its 64-step walk
    was 64% of an export batch on the card.

    Returns (positions [Q, 3], face normals [Q, 3], depth [Q], face
    index [Q] int64): depth ``miss_depth`` and face -1 on a miss (callers
    test depth > 9.5)."""
    d = rays_d / (torch.linalg.norm(rays_d, dim=-1, keepdim=True) + 1e-12)
    res, cs = grid.res, grid.cell_size
    lo = grid.origin
    hi = grid.origin + cs * res
    # entry point by the slab test, origins clamped into the grid's box
    safe_d = torch.where(torch.abs(d) > 1e-12, d,
                         torch.where(d >= 0, 1e-12, -1e-12))
    t0 = (lo - rays_o) / safe_d
    t1 = (hi - rays_o) / safe_d
    tmin = torch.amax(torch.minimum(t0, t1), dim=-1)
    tmax = torch.amin(torch.maximum(t0, t1), dim=-1)
    t_enter = torch.clamp(tmin, min=0.0)
    active = tmax >= t_enter
    start = rays_o + (t_enter[:, None] + 1e-6 * cs) * d
    cell = _cell_of(start, grid.origin, cs, res)
    step = torch.where(d >= 0, 1, -1).to(torch.int64)
    inv_d = 1.0 / safe_d
    # distance to the next cell boundary along each axis
    next_bound = grid.origin + (cell + (step > 0)).to(torch.float32) * cs
    t_next = (next_bound - rays_o) * inv_d
    t_delta = torch.abs(cs * inv_d)
    tri_soa = _triangle_soa(vertices, faces)
    o_soa, d_soa = _split3(rays_o), _split3(d)
    Q = rays_o.shape[0]
    best_t = torch.full((Q,), torch.inf, device=rays_o.device)
    best_f = torch.full((Q,), -1, dtype=torch.int64, device=rays_o.device)
    eye = torch.eye(3, dtype=torch.int64, device=rays_o.device)
    for step_i in range(max_steps):
        if step_i % SYNC_STEPS == SYNC_STEPS - 1 and not bool(active.any()):
            break
        # a ray that walked out of the grid is inactive; clamp its cell
        # for the gather (JAX's gather clamps out-of-range indices)
        cand = grid.cell_items[_flat(torch.clamp(cell, 0, res - 1), res)]
        t, hit = _mt_soa(o_soa, d_soa, tri_soa, torch.clamp(cand, min=0))
        t = torch.where((cand >= 0) & hit, t, torch.inf)
        tmin_c, j = torch.min(t, dim=-1)
        fmin = torch.gather(cand, 1, j[:, None])[:, 0]
        cell_t_exit = torch.amin(t_next, dim=-1)
        ok = active & (tmin_c <= cell_t_exit + 1e-5) & torch.isfinite(tmin_c)
        upd = ok & (tmin_c < best_t)
        best_t = torch.where(upd, tmin_c, best_t)
        best_f = torch.where(upd, fmin, best_f)
        active = active & ~ok
        one_hot = eye[torch.argmin(t_next, dim=-1)]             # DDA advance
        cell = cell + one_hot * step
        t_next = t_next + one_hot.to(t_next.dtype) * t_delta
        active = active & ~torch.any((cell < 0) | (cell >= res), dim=-1)
    hit = torch.isfinite(best_t)
    depth = torch.where(hit, best_t, miss_depth)
    pos = rays_o + depth[:, None] * d
    fn = _face_normals(vertices, faces)
    normals = torch.where(hit[:, None], fn[torch.clamp(best_f, min=0)], 0.0)
    return pos, normals, depth, torch.where(hit, best_f, -1)


def _ptc_soa(p_soa, tri_soa, idx: torch.Tensor):
    """Closest points on the faces idx [Q, M] to the points (per-axis
    [Q]): (dist^2, qx, qy, qz, u, v, w), each [Q, M] (the region-partition
    algorithm of ``triangle.point_triangle_closest``, per axis)."""
    px, py, pz = (c[:, None] for c in p_soa)
    ax, ay, az, bx, by, bz, cx, cy, cz = (c[idx] for c in tri_soa)
    abx, aby, abz = bx - ax, by - ay, bz - az
    acx, acy, acz = cx - ax, cy - ay, cz - az
    apx, apy, apz = px - ax, py - ay, pz - az
    bpx, bpy, bpz = px - bx, py - by, pz - bz
    cpx, cpy, cpz = px - cx, py - cy, pz - cz
    u, v, w = _closest_weights(
        abx * apx + aby * apy + abz * apz, acx * apx + acy * apy + acz * apz,
        abx * bpx + aby * bpy + abz * bpz, acx * bpx + acy * bpy + acz * bpz,
        abx * cpx + aby * cpy + abz * cpz, acx * cpx + acy * cpy + acz * cpz)
    qx = u * ax + v * bx + w * cx
    qy = u * ay + v * by + w * cy
    qz = u * az + v * bz + w * cz
    dist_sq = (px - qx) ** 2 + (py - qy) ** 2 + (pz - qz) ** 2
    return dist_sq, qx, qy, qz, u, v, w


@torch.no_grad()
def nearest_face(grid: GridIndex, vertices: torch.Tensor,
                 faces: torch.Tensor, points: torch.Tensor):
    """The nearest triangle to each point [Q, 3] among its 27-cell
    candidates (the lowest candidate slot on a tie): (unsigned distance
    [Q], face index [Q] int64, barycentric [Q, 3], closest point
    [Q, 3]).  The caller signs the distance."""
    cand = gather_candidates(grid, points)                       # [Q, C]
    d2, cx, cy, cz, bu, bv, bw = _ptc_soa(
        _split3(points), _triangle_soa(vertices, faces),
        torch.clamp(cand, min=0))
    d2 = torch.where(cand >= 0, d2, torch.inf)
    j = torch.argmin(d2, dim=-1)[:, None]

    def take(a):
        return torch.gather(a, 1, j)[:, 0]

    return (torch.sqrt(take(d2)), take(cand),
            torch.stack([take(bu), take(bv), take(bw)], -1),
            torch.stack([take(cx), take(cy), take(cz)], -1))
