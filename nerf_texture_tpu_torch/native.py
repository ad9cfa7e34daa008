"""The grid-hash engine's table builders (port of
``nerf_texture_tpu/native.py``).

The JAX package binds ``native/spatial_build.cpp`` through ctypes and
builds its vertex and triangle tables on the host; it finds each cell's
fallback list with a host ``scipy.spatial.cKDTree``.  Here the same
tables come from the hand-written kernels of ``csrc/spatial_build.cu``
(built at first use, see ``kernels.py``):

- ``build_vertex_grid`` / ``build_triangle_grid``: the ``[res**3, M]``
  int32 item lists of a uniform grid, each cell's lowest ids first,
  -1 padded, bit for bit with the C++ builder.  A cell is found in
  float32 as that builder finds it: ``(int)((v - origin) / cell_size)``
  on float32 vertices, origin and cell size, truncated toward zero and
  clamped to ``[0, res - 1]``; a triangle covers the cells of its
  float32 corners' AABB.
- ``kdtree`` / ``build_fallback``: the ``[res**3, n_fallback]`` ids of
  the items nearest to each cell centre, in float64, edge-padded when
  there are fewer items (``_build_fallback`` of the JAX package's
  ``geometry/spatial.py``), bit for bit with the JAX package's lists.
  Those come from scipy's cKDTree, which among items at equal distance
  keeps those its walk meets first.  Such ties are common (a UV atlas
  duplicates its seam vertices; a symmetric mesh puts cell centres at
  equal distances from several items), and no rule but that walk
  reproduces them.  So ``kdtree`` builds cKDTree on the host (a fraction
  of a second at 327,680 items) and lays its nodes out as tensors on the
  device; the kernel then runs cKDTree's query over them step for step,
  one thread a cell centre.

On a CUDA tensor each function launches its kernels and counts the call
in its ``launches`` attribute, or raises; nothing falls back to the
host.  On a CPU tensor it runs its ``*_reference`` twin, the plain
version: the binning in torch, and the fallback through cKDTree's own
query, exactly as the JAX package queries it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

FALLBACK_K = 8      # the most items the kd-tree kernel keeps a cell
KD_QMAX = 1024      # node-heap entries a row starts with (x4 on overflow)
KD_ROWS = 65536     # cell centres a kd-tree launch takes


@functools.cache
def _lib():
    from .kernels import load_library

    lib = load_library("spatial_build")
    p, i64, i32, f32, f64 = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                             ctypes.c_float, ctypes.c_double)
    for fn, args in (
            (lib.spatial_bin_count,
             [p, p, i64, i32, f32, f32, f32, f32, p, p, p, p]),
            (lib.spatial_bin_fill,
             [p, p, i64, i32, f32, f32, f32, f32, p, p, p, i32, p, p]),
            (lib.spatial_kd_nearest,
             [p, p, p, p, p, p, i64, i64, i32, f64, f64, f64, f64, i32,
              i32, i32, p, p, p, p, p, p])):
        fn.restype = ctypes.c_int
        fn.argtypes = args
    return lib


def available() -> bool:
    """Whether the CUDA library of the builders builds and loads."""
    try:
        _lib()
    except (RuntimeError, OSError):
        return False
    return True


def _f32(x) -> float:
    """A float64 value rounded to float32, as ctypes' c_float rounds it."""
    return float(np.float32(x))


def _check(err: int, what: str):
    if err != 0:
        why = "bad arguments" if err == -1 else f"CUDA error {err}"
        raise RuntimeError(f"{what} failed: {why}")


# ---------------------------------------------------------------------------
# the plain versions
# ---------------------------------------------------------------------------

def _cells(x: torch.Tensor, origin, cell_size, res: int) -> torch.Tensor:
    """Per-axis cells of float32 points x [..., 3]: (x - o) / cs in
    float32 (a tensor divisor: on CUDA a Python scalar divides as a
    multiply by its reciprocal), truncated toward zero, clamped."""
    o = torch.tensor([_f32(v) for v in origin], dtype=torch.float32,
                     device=x.device)
    d = x - o
    c = (d / torch.full_like(d, _f32(cell_size))).to(torch.int64)
    return torch.clamp(c, 0, res - 1)


def _lists(cell: torch.Tensor, item: torch.Tensor, n_cells: int,
           M: int) -> torch.Tensor:
    """[n_cells, M] int32: each cell's first M items by id, -1 padded, of
    the (cell, item) pairs."""
    out = torch.full((n_cells, M), -1, dtype=torch.int32, device=cell.device)
    if cell.numel() == 0:
        return out
    n = int(item.max()) + 1
    key, _ = torch.sort(cell * n + item)
    cell, item = key // n, key % n
    _, counts = torch.unique_consecutive(cell, return_counts=True)
    start = torch.repeat_interleave(torch.cumsum(counts, 0) - counts, counts)
    rank = torch.arange(len(cell), device=cell.device) - start
    keep = rank < M
    out[cell[keep], rank[keep]] = item[keep].to(torch.int32)
    return out


def build_vertex_grid_reference(verts: torch.Tensor, res: int, origin,
                                cell_size, max_per_cell: int
                                ) -> torch.Tensor:
    """Plain ``build_vertex_grid``."""
    c = _cells(torch.as_tensor(verts).to(torch.float32), origin, cell_size,
               res)
    flat = (c[:, 0] * res + c[:, 1]) * res + c[:, 2]
    return _lists(flat, torch.arange(len(flat), device=flat.device),
                  res ** 3, max_per_cell)


def build_triangle_grid_reference(verts: torch.Tensor, faces: torch.Tensor,
                                  res: int, origin, cell_size,
                                  max_per_cell: int) -> torch.Tensor:
    """Plain ``build_triangle_grid``: every (cell, face) pair of each
    face's AABB cells."""
    v = torch.as_tensor(verts).to(torch.float32)
    tri = v[torch.as_tensor(faces, device=v.device).to(torch.int64)]
    tmin = _cells(tri.amin(1), origin, cell_size, res)
    tmax = _cells(tri.amax(1), origin, cell_size, res)
    span = tmax - tmin + 1
    n = span.prod(1)
    fid = torch.repeat_interleave(torch.arange(len(n), device=v.device), n)
    loc = torch.arange(int(n.sum()), device=v.device) \
        - torch.repeat_interleave(torch.cumsum(n, 0) - n, n)
    sy = torch.repeat_interleave(span[:, 1], n)
    sz = torch.repeat_interleave(span[:, 2], n)
    cxyz = torch.repeat_interleave(tmin, n, dim=0) + torch.stack(
        [loc // (sy * sz), (loc // sz) % sy, loc % sz], -1)
    cell = (cxyz[:, 0] * res + cxyz[:, 1]) * res + cxyz[:, 2]
    return _lists(cell, fid, res ** 3, max_per_cell)


class KDTree(NamedTuple):
    """scipy's cKDTree over a fallback list's items, and its nodes laid
    out for the kd-tree kernel, on one device."""
    tree: object            # the host cKDTree (the plain version queries it)
    points: torch.Tensor    # [N, 3] float64, the items in leaf order
    ids: torch.Tensor       # [N] int32, each of those items' id
    nodes: torch.Tensor     # [n_nodes, 4] int32: split dim (-1: a leaf),
    #                         lesser / first point, greater / end, 0
    splits: torch.Tensor    # [n_nodes] float64
    rects: torch.Tensor     # [n_nodes, 6] float64: lo xyz, hi xyz


def kdtree(points: np.ndarray, device) -> KDTree:
    """cKDTree of points ([N, 3] float64, host) as the JAX package builds
    it (scipy's defaults), its nodes in preorder.  A node's rect is its
    box as the query's splits cut it from the data's bounds: the walk
    carries each axis's squared side distance to that box, and the
    kernel finds it again from the rect when it pops the node."""
    from scipy.spatial import cKDTree

    pts = np.ascontiguousarray(points, np.float64)
    tree = cKDTree(pts)
    nodes, splits, rects = [], [], []
    stack = [(tree.tree, -1, 0, np.asarray(tree.mins, np.float64),
              np.asarray(tree.maxes, np.float64))]
    while stack:
        n, parent, side, lo, hi = stack.pop()
        i = len(nodes)
        if parent >= 0:
            nodes[parent][1 + side] = i
        rects.append(np.concatenate([lo, hi]))
        splits.append(n.split if n.split_dim >= 0 else 0.0)
        if n.split_dim < 0:
            nodes.append([-1, n.start_idx, n.end_idx, 0])
            continue
        nodes.append([n.split_dim, -1, -1, 0])
        d = n.split_dim
        lo_g, hi_l = lo.copy(), hi.copy()
        lo_g[d] = hi_l[d] = n.split
        # the lesser child next (preorder), the greater after its subtree
        stack.append((n.greater, i, 1, lo_g, hi))
        stack.append((n.lesser, i, 0, lo, hi_l))
    idx = np.asarray(tree.indices)
    return KDTree(
        tree, torch.as_tensor(pts[idx], device=device),
        torch.as_tensor(idx.astype(np.int32), device=device),
        torch.as_tensor(np.asarray(nodes, np.int32), device=device),
        torch.as_tensor(np.asarray(splits, np.float64), device=device),
        torch.as_tensor(np.asarray(rects, np.float64), device=device))


def build_fallback_reference(tree: KDTree, res: int, origin, cell_size,
                             n_fallback: int) -> torch.Tensor:
    """Plain ``build_fallback``: cKDTree's query (host, every core), as
    the JAX package's ``_build_fallback`` makes it."""
    centers = cell_centres(res, origin, cell_size, "cpu").numpy()
    k = min(n_fallback, len(tree.ids))
    _, idx = tree.tree.query(centers, k=k, workers=-1)
    idx = np.asarray(idx, np.int32).reshape(res ** 3, k)
    if k < n_fallback:
        idx = np.pad(idx, ((0, 0), (0, n_fallback - k)), mode="edge")
    return torch.as_tensor(idx, device=tree.points.device)


def cell_centres(res: int, origin, cell_size, device) -> torch.Tensor:
    """[res**3, 3] float64 cell centres ``(i + 0.5) * cell_size + origin``,
    rounded as the kernel and numpy round them."""
    r = torch.arange(res, dtype=torch.float64, device=device)
    ijk = torch.stack(torch.meshgrid(r, r, r, indexing="ij"), -1)
    o = torch.as_tensor(np.asarray(origin, np.float64), device=device)
    return ((ijk.reshape(-1, 3) + 0.5) * float(cell_size)) + o


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

def _cuda_only(fn: str, *tensors) -> torch.device:
    """The one CUDA device of ``tensors``; raises on any other mix."""
    dev = tensors[0].device
    if any(t.device.type != "cuda" or t.device != dev for t in tensors):
        raise ValueError(f"{fn}: tensors on "
                         f"{[str(t.device) for t in tensors]}")
    return dev


def _bin(verts: torch.Tensor, faces, res: int, origin, cell_size,
         max_per_cell: int, total=None) -> torch.Tensor:
    """The binning kernels on the card: count, scan, fill, the cells'
    lists.  ``total``, the number of (cell, item) pairs, is known for a
    vertex grid; for a triangle grid it is read back after the scan (4
    bytes) to size the pair scratch."""
    dev = verts.device
    v = verts.to(torch.float32).contiguous()
    n = len(v) if faces is None else len(faces)
    if n >= 2 ** 31 or max_per_cell < 1:
        raise ValueError(f"binning: {n} items, max_per_cell {max_per_cell}")
    f = None if faces is None else faces.to(torch.int32).contiguous()
    n_cells = res ** 3
    counts = torch.empty(n_cells, dtype=torch.int32, device=dev)
    offsets = torch.empty(n_cells + 1, dtype=torch.int64, device=dev)
    cursor = torch.empty(n_cells, dtype=torch.int64, device=dev)
    grid = (res, *(_f32(x) for x in origin), _f32(cell_size))
    fp = None if f is None else f.data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    _check(_lib().spatial_bin_count(v.data_ptr(), fp, n, *grid,
                                    counts.data_ptr(), offsets.data_ptr(),
                                    cursor.data_ptr(), stream),
           "spatial_bin_count")
    if total is None:
        total = int(offsets[n_cells])
    pairs = torch.empty(max(total, 1), dtype=torch.int32, device=dev)
    out = torch.empty((n_cells, max_per_cell), dtype=torch.int32, device=dev)
    _check(_lib().spatial_bin_fill(v.data_ptr(), fp, n, *grid,
                                   offsets.data_ptr(), cursor.data_ptr(),
                                   pairs.data_ptr(), max_per_cell,
                                   out.data_ptr(), stream),
           "spatial_bin_fill")
    return out


def build_vertex_grid(verts: torch.Tensor, res: int, origin, cell_size,
                      max_per_cell: int) -> torch.Tensor:
    """[res**3, max_per_cell] int32: the ids of each cell's vertices
    (verts [N, 3]), lowest first, -1 padded; on the device of verts."""
    verts = torch.as_tensor(verts)
    if verts.device.type == "cpu":
        return build_vertex_grid_reference(verts, res, origin, cell_size,
                                           max_per_cell)
    _cuda_only("build_vertex_grid", verts)
    out = _bin(verts, None, res, origin, cell_size, max_per_cell,
               total=len(verts))
    build_vertex_grid.launches += 1
    return out


def build_triangle_grid(verts: torch.Tensor, faces: torch.Tensor, res: int,
                        origin, cell_size, max_per_cell: int
                        ) -> torch.Tensor:
    """[res**3, max_per_cell] int32: the ids of the faces ([F, 3] into
    verts [V, 3]) whose AABB overlaps each cell, lowest first, -1
    padded; on the device of verts."""
    verts, faces = torch.as_tensor(verts), torch.as_tensor(faces)
    if verts.device.type == "cpu":
        return build_triangle_grid_reference(verts, faces, res, origin,
                                             cell_size, max_per_cell)
    _cuda_only("build_triangle_grid", verts, faces)
    out = _bin(verts, faces, res, origin, cell_size, max_per_cell)
    build_triangle_grid.launches += 1
    return out


def build_fallback(tree: KDTree, res: int, origin, cell_size,
                   n_fallback: int) -> torch.Tensor:
    """[res**3, n_fallback] int32: the ids of the items of ``tree``
    (``kdtree``) nearest to each cell centre ``(i + 0.5) * cell_size +
    origin``, nearest first, cKDTree's order among equal distances, the
    last repeated when there are fewer than n_fallback items (at most
    ``FALLBACK_K`` a list); on the device of the tree.  On the card the
    kernel's distance evaluations of the call are left in
    ``build_fallback.evaluations`` (a one-element tensor there)."""
    if tree.points.device.type == "cpu":
        return build_fallback_reference(tree, res, origin, cell_size,
                                        n_fallback)
    dev = _cuda_only("build_fallback", tree.points, tree.ids, tree.nodes,
                     tree.splits, tree.rects)
    k = min(n_fallback, len(tree.ids))
    if not 1 <= k <= FALLBACK_K:
        raise ValueError(f"build_fallback: {k} nearest of "
                         f"{len(tree.ids)} items (1 to {FALLBACK_K})")
    n_cells = res ** 3
    out = torch.empty((n_cells, n_fallback), dtype=torch.int32, device=dev)
    evals = torch.zeros(1, dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    frame = (res, *(float(x) for x in origin), float(cell_size))
    ptrs = (tree.points.data_ptr(), tree.ids.data_ptr(),
            tree.nodes.data_ptr(), tree.splits.data_ptr(),
            tree.rects.data_ptr())

    def launch(rows, row0, n_rows, qmax):
        qpr = torch.empty((n_rows, qmax), dtype=torch.float64, device=dev)
        qnode = torch.empty((n_rows, qmax), dtype=torch.int32, device=dev)
        flag = torch.empty(n_rows, dtype=torch.int32, device=dev)
        _check(_lib().spatial_kd_nearest(
            *ptrs, None if rows is None else rows.data_ptr(), row0, n_rows,
            *frame, k, n_fallback, qmax, qpr.data_ptr(), qnode.data_ptr(),
            out.data_ptr(), flag.data_ptr(), evals.data_ptr(), stream),
            "spatial_kd_nearest")
        return flag

    # every row at KD_QMAX node-heap entries (the walk pushes a node at
    # most once: never more than the nodes), KD_ROWS rows a launch; the
    # rows whose heap outgrew it (one 4-byte read-back a launch, their
    # ids only if any) again with four times as many
    n_nodes = len(tree.nodes)
    qmax = min(KD_QMAX, n_nodes)
    again = []
    for row0 in range(0, n_cells, KD_ROWS):
        n_rows = min(KD_ROWS, n_cells - row0)
        flag = launch(None, row0, n_rows, qmax)
        if int(flag.sum()):
            again.append(torch.nonzero(flag)[:, 0] + row0)
    while again:
        if qmax == n_nodes:
            raise RuntimeError("build_fallback: a node heap outgrew the "
                               "tree")
        rows, again, qmax = torch.cat(again), [], min(4 * qmax, n_nodes)
        for i in range(0, len(rows), KD_ROWS):
            part = rows[i:i + KD_ROWS].contiguous()
            flag = launch(part, 0, len(part), qmax)
            if int(flag.sum()):
                again.append(part[torch.nonzero(flag)[:, 0]])
    build_fallback.launches += 1
    build_fallback.evaluations = evals
    return out


build_vertex_grid.launches = 0
build_triangle_grid.launches = 0
build_fallback.launches = 0
build_fallback.evaluations = None
