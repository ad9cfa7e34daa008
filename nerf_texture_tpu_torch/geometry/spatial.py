"""Grid-hash spatial index (port of ``nerf_texture_tpu/geometry/spatial.py``,
the part the curved serving path runs).

One uniform voxel index over the mesh's items (vertices or triangles),
built once per mesh on the host (numpy) and shipped to the device as
padded fixed-width tables; a query gathers the candidate ids of the
cells around a point plus a per-cell fallback list (the items nearest
to the cell centre, so a far query still gets real candidates) and
picks among them with tensor math.

The JAX package builds the cell lists with a C++ helper when g++ is
present and with numpy otherwise; this port always takes the numpy
builder.  The two fill a cell's list in different orders, so their
tables may differ in the padded layout, but ``knn`` returns the same
neighbours from either (it sorts candidates by id).

Not on the serving path, and not ported: ``raycast`` and
``nearest_face`` (the exact per-sample projection and the signed
distance); each raises ``NotImplementedError`` naming its ROADMAP item.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


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
    lists up to ``max_per_cell`` of its items, lowest ids first."""
    pts = np.asarray(points_per_item, np.float64)
    lo = pts.min(0) - aabb_pad
    hi = pts.max(0) + aabb_pad
    cell_size = float((hi - lo).max() / res)
    coords = np.clip(((pts - lo) / cell_size).astype(np.int64), 0, res - 1)
    flat = (coords[:, 0] * res + coords[:, 1]) * res + coords[:, 2]
    cell_items = -np.ones((res ** 3, max_per_cell), np.int32)
    fill = np.zeros(res ** 3, np.int64)
    for i in np.argsort(flat, kind="stable"):
        c = flat[i]
        if fill[c] < max_per_cell:
            cell_items[c, fill[c]] = i
            fill[c] += 1
    fallback = _build_fallback(pts, lo, cell_size, res, n_fallback)
    return _index(cell_items, fallback, lo, cell_size, res, device)


def _build_fallback(pts, lo, cell_size, res, n_fallback):
    """[res**3, n_fallback] ids of the items nearest to each cell centre
    (host cKDTree), edge-padded when there are fewer items."""
    from scipy.spatial import cKDTree

    tree = cKDTree(pts)
    r = np.arange(res)
    xx, yy, zz = np.meshgrid(r, r, r, indexing="ij")
    centers = (np.stack([xx, yy, zz], -1).reshape(-1, 3) + 0.5) * cell_size \
        + lo
    k = min(n_fallback, len(pts))
    _, idx = tree.query(centers, k=k)
    idx = np.asarray(idx, np.int32).reshape(res ** 3, k)
    if k < n_fallback:
        idx = np.pad(idx, ((0, 0), (0, n_fallback - k)), mode="edge")
    return idx


def build_triangle_grid(vertices: np.ndarray, faces: np.ndarray, res: int,
                        max_per_cell: int, n_fallback: int = 8,
                        device: torch.device | str = "cuda") -> GridIndex:
    """Bin triangles into every cell their AABB overlaps (conservative);
    the fallback lists hold the triangles nearest by centroid."""
    tris = np.asarray(vertices, np.float64)[np.asarray(faces)]
    lo = tris.reshape(-1, 3).min(0) - 1e-3
    hi = tris.reshape(-1, 3).max(0) + 1e-3
    cell_size = float((hi - lo).max() / res)
    tmin = np.clip(((tris.min(1) - lo) / cell_size).astype(np.int64),
                   0, res - 1)
    tmax = np.clip(((tris.max(1) - lo) / cell_size).astype(np.int64),
                   0, res - 1)
    cell_lists: dict[int, list[int]] = {}
    for fi in range(len(tris)):
        for x in range(tmin[fi, 0], tmax[fi, 0] + 1):
            for y in range(tmin[fi, 1], tmax[fi, 1] + 1):
                for z in range(tmin[fi, 2], tmax[fi, 2] + 1):
                    cell_lists.setdefault((x * res + y) * res + z,
                                          []).append(fi)
    cell_items = -np.ones((res ** 3, max_per_cell), np.int32)
    for c, items in cell_lists.items():
        m = min(len(items), max_per_cell)
        cell_items[c, :m] = items[:m]
    fallback = _build_fallback(tris.mean(1), lo, cell_size, res, n_fallback)
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


def raycast(*args, **kwargs):
    raise NotImplementedError(
        "spatial.raycast: the DDA ray cast (exact per-sample projection) is "
        "not ported; ROADMAP Queue 1, item 7")


def nearest_face(*args, **kwargs):
    raise NotImplementedError(
        "spatial.nearest_face: the nearest-triangle query is not ported; "
        "ROADMAP Queue 1, item 7")
