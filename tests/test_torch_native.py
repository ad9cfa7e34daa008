"""The port's grid-hash table builders (``nerf_texture_tpu_torch/native.py``
and ``geometry/spatial.py``) against the JAX package's native builder.

The JAX package bins with ``native/spatial_build.cpp`` (float32 cells)
whenever g++ is present and finds the fallback lists with cKDTree.  On
the CPU the port runs the plain versions of its kernels: the float32
binning in torch and cKDTree's own query.  Held here, bit for bit:

- ``native.build_vertex_grid`` / ``build_triangle_grid`` against the JAX
  package's ``native.*`` on icospheres, a noisy icosphere, the rounded
  box, a grid whose origin leaves points outside it (the clamp), and a
  boundary fixture: seeded points within 3e-8 of cell faces, where a
  float64 cell and a float32 cell differ;
- ``spatial.build_grid`` / ``build_triangle_grid`` (tables, fallback
  lists, origin, cell size) against the JAX package's on the same meshes;
- the fallback lists against the JAX package's ``_build_fallback``, with
  fewer items than slots (edge padding) too;
- the kd-tree kernel's walk, run here in Python over the tensors
  ``native.kdtree`` lays out for it (``_kd_walk``, a line-for-line twin
  of ``kd_nearest`` in ``csrc/spatial_build.cu``), against cKDTree's
  query: on a lattice whose cell centres lie at equal distances from
  many items, on points repeated 20 times, on a UV-atlased icosphere
  (duplicated seam vertices), a symmetric icosphere and random points.
  Among items at equal distance cKDTree keeps those its walk meets
  first; the lowest ids would differ in many rows (checked too).

The kernels themselves run in ``tests/test_torch_native_cuda.py`` (marked
``cuda``).  Each case takes well under a second.
"""

import numpy as np
import pytest
import torch

from nerf_texture_tpu import native as jnative
from nerf_texture_tpu.geometry import mesh as jmesh
from nerf_texture_tpu.geometry import shape_tools as jst
from nerf_texture_tpu.geometry import spatial as jspatial
from nerf_texture_tpu_torch.geometry import spatial as tspatial


@pytest.fixture
def tnative():
    from nerf_texture_tpu_torch import native

    return native


def _noisy(m, seed=0, amp=0.01):
    rng = np.random.default_rng(seed)
    return jmesh.Mesh(m.vertices + rng.normal(0, amp, m.vertices.shape),
                      m.faces)


def _boundary(res=16, n_uniform=2000, n_edge=500, seed=0):
    """A mesh whose vertices include n_edge seeded points within 3e-8 of
    a cell face of the res^3 grid that build_grid puts over them (two
    anchors at -1 and +1 fix that grid), each the corner of a small face
    whose other two corners lie within a cell of it on either side."""
    rng = np.random.default_rng(seed)
    u = rng.uniform(-1, 1, (n_uniform, 3))
    u[0], u[1] = -1.0, 1.0
    lo = u.min(0) - 1e-3
    cs = float((u.max(0) + 1e-3 - lo).max() / res)
    b = u[rng.integers(2, n_uniform, n_edge)].copy()
    ax = rng.integers(0, 3, n_edge)
    k = rng.integers(1, res, n_edge)
    b[np.arange(n_edge), ax] = lo[ax] + k * cs \
        + rng.uniform(-3e-8, 3e-8, n_edge)
    others = [np.clip(b + rng.uniform(-0.5, 0.5, b.shape) * cs, -1, 1)
              for _ in range(2)]
    verts = np.concatenate([u, b] + others)
    ids = n_uniform + np.arange(n_edge)
    faces = np.concatenate([[[0, 1, 2]], np.stack(
        [ids, ids + n_edge, ids + 2 * n_edge], -1)])
    return jmesh.Mesh(verts, faces.astype(np.int64))


def _rounded_box():
    return jst.laplacian_smooth(jst.subdivide_to(
        jmesh.make_box((0.5, 0.35, 0.25)), 2000), 8)


MESHES = {
    "icosphere2": lambda: jmesh.make_icosphere(2, radius=0.5),
    "icosphere3": lambda: jmesh.make_icosphere(3, radius=0.5),
    "icosphere4": lambda: jmesh.make_icosphere(4, radius=0.5),
    "noisy_icosphere": lambda: _noisy(jmesh.make_icosphere(3, radius=0.5)),
    "rounded_box": _rounded_box,
    "boundary": _boundary,
}


def _res(name, m):
    """MeshProjector's default grid resolution; the boundary fixture's own."""
    if name == "boundary":
        return 16
    return int(np.clip(round(len(m.vertices) ** (1 / 3) * 2), 8, 64))


def _grid(points, res, pad=1e-3):
    lo = points.min(0) - pad
    return lo, float((points.max(0) + pad - lo).max() / res)


@pytest.mark.parametrize("name", list(MESHES))
def test_spatial_tables_match_jax(name):
    """build_grid / build_triangle_grid: the cell lists bit for bit with
    the JAX package's native tables, the same origin, cell size and
    fallback lists."""
    m = MESHES[name]()
    res = _res(name, m)
    for got, want in (
            (tspatial.build_grid(m.vertices, res, 16, device="cpu"),
             jspatial.build_grid(m.vertices, res, 16)),
            (tspatial.build_triangle_grid(m.vertices, m.faces, res, 24,
                                          device="cpu"),
             jspatial.build_triangle_grid(m.vertices, m.faces, res, 24))):
        assert got.res == want.res
        for a, b in ((got.cell_items, want.cell_items),
                     (got.fallback, want.fallback),
                     (got.origin, want.origin),
                     (got.cell_size, want.cell_size)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("name", list(MESHES) + ["outside"])
def test_native_tables_match_jax(tnative, name):
    """native.build_vertex_grid / build_triangle_grid bit for bit with the
    JAX package's native builder, at M 16 / 24 and at M 2 (cells over
    M); "outside" puts the grid's origin inside the mesh, so that cells
    clamp on every side."""
    m = MESHES["icosphere3" if name == "outside" else name]()
    res = _res(name, m)
    lo, cs = _grid(m.vertices, res)
    if name == "outside":
        lo, cs = lo + 0.3, cs * 0.6
    for M in (2, 16):
        np.testing.assert_array_equal(
            tnative.build_vertex_grid(torch.as_tensor(m.vertices), res, lo,
                                      cs, M).numpy(),
            jnative.build_vertex_grid(m.vertices, res, lo, cs, M))
        np.testing.assert_array_equal(
            tnative.build_triangle_grid(torch.as_tensor(m.vertices),
                                        torch.as_tensor(m.faces), res, lo,
                                        cs, M + 8).numpy(),
            jnative.build_triangle_grid(m.vertices, m.faces, res, lo, cs,
                                        M + 8))


def test_boundary_fixture_parts_float64_cells():
    """The fixture is one where the float64 binning of the port's numpy
    builder put points into other cells than the native builder does."""
    m = _boundary()
    lo, cs = _grid(m.vertices, 16)
    f64 = np.clip(((m.vertices - lo) / cs).astype(np.int64), 0, 15)
    f32 = np.clip(((m.vertices.astype(np.float32) - lo.astype(np.float32))
                   / np.float32(cs)).astype(np.int64), 0, 15)
    assert (f64 != f32).any(1).sum() >= 100


def _kd_walk(tree, x, k):
    """The kernel's walk (``kd_nearest``) in Python over ``native.kdtree``'s
    tensors: cKDTree's best-first query with its node heap and item heap,
    a popped node's side distances found again from its rect."""

    def push(h, pr, v):
        h.append((pr, v))
        i = len(h) - 1
        while i > 0 and h[i][0] < h[(i - 1) // 2][0]:
            h[i], h[(i - 1) // 2] = h[(i - 1) // 2], h[i]
            i = (i - 1) // 2

    def remove(h):
        h[0] = h[-1]
        h.pop()
        n, i, j, m = len(h), 0, 1, 2
        while (j < n and h[i][0] > h[j][0]) or (m < n and h[i][0] > h[m][0]):
            lo = m if (m < n and h[j][0] > h[m][0]) else j
            h[lo], h[i] = h[i], h[lo]
            i, j, m = lo, 2 * lo + 1, 2 * lo + 2

    def side2(v, lo, hi):
        t = v - hi
        s = t if t > 0.0 else max(lo - v, 0.0)
        return s * s

    pts, ids = tree.points.numpy(), tree.ids.numpy()
    nodes, splits, rects = (tree.nodes.numpy(), tree.splits.numpy(),
                            tree.rects.numpy())
    side = [side2(x[d], rects[0, d], rects[0, 3 + d]) for d in range(3)]
    mind = 0.0
    for d in range(3):
        mind += side[d] - 0.0
    node, dub, q, nb = 0, np.inf, [], []
    while True:
        dim, a, b, _ = nodes[node]
        if dim == -1:
            for i in range(a, b):
                s = 0.0
                for d in range(3):
                    dd = pts[i, d] - x[d]
                    s += dd * dd
                if s < dub:
                    if len(nb) == k:
                        remove(nb)
                    push(nb, -s, int(ids[i]))
                    if len(nb) == k:
                        dub = -nb[0][0]
            if not q:
                break
            mind, node = q[0]
            remove(q)
            side = [side2(x[d], rects[node, d], rects[node, 3 + d])
                    for d in range(3)]
        else:
            if mind > dub:
                break
            split = splits[node]
            if x[dim] < split:
                node, far, sd = a, b, split - x[dim]
            else:
                node, far, sd = b, a, x[dim] - split
            sd = sd * sd
            far_mind = mind + (sd - side[dim])
            if far_mind <= dub:
                push(q, far_mind, far)
    out = [0] * len(nb)
    for i in range(len(nb) - 1, -1, -1):
        out[i] = nb[0][1]
        remove(nb)
    return out


def _lattice():
    r = np.arange(6, dtype=np.float64)
    pts = np.stack(np.meshgrid(r, r, r, indexing="ij"), -1).reshape(-1, 3)
    return pts[np.random.default_rng(0).permutation(len(pts))]


def _repeated(copies=20):
    rng = np.random.default_rng(copies)
    base = rng.uniform(-1, 1, (40, 3))
    return np.repeat(base, copies, 0)[rng.permutation(40 * copies)]


def _atlas():
    from nerf_texture_tpu_torch.geometry.projector import uv_atlas

    return uv_atlas(jmesh.make_icosphere(2, radius=0.5)).vertices


WALKS = {
    "lattice": _lattice,
    "repeated": _repeated,
    "atlas": _atlas,
    "icosphere": lambda: jmesh.make_icosphere(2, radius=0.5).vertices,
    "random": lambda: np.random.default_rng(5).uniform(-1, 1, (1500, 3)),
}


@pytest.mark.parametrize("name", list(WALKS))
def test_kd_walk_is_ckdtrees_query(tnative, name):
    """The kernel's walk over ``kdtree``'s tensors gives cKDTree's lists,
    ties and their order included, at every cell centre; ties that a
    lower-id rule would break otherwise occur in the tied fixtures."""
    pts = np.asarray(WALKS[name](), np.float64)
    res = 10
    lo, cs = _grid(pts, res)
    tree = tnative.kdtree(pts, "cpu")
    assert torch.equal(tree.points, torch.as_tensor(pts[tree.tree.indices]))
    want = tnative.build_fallback(tree, res, lo, cs, 8).numpy()
    cent = tnative.cell_centres(res, lo, cs, "cpu").numpy()
    got = np.asarray([_kd_walk(tree, c, 8) for c in cent])
    np.testing.assert_array_equal(got, want)
    if name in ("lattice", "repeated", "atlas"):
        lower = _lower_id_nearest(pts, res, lo, cs, 8, tnative)[0].numpy()
        assert (np.sort(lower, 1) != np.sort(want, 1)).any(1).sum() > 0


def _lower_id_nearest(points, res, lo, cs, k, tnative):
    """The k nearest by brute force in float64 torch, (dx*dx + dy*dy) +
    dz*dz, the lower id first among equal distances."""
    p = torch.as_tensor(points, dtype=torch.float64)
    d = tnative.cell_centres(res, lo, cs, "cpu")[:, None, :] - p[None]
    d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) \
        + d[..., 2] * d[..., 2]
    _, order = torch.sort(d2, dim=1, stable=True)
    return order[:, :k].to(torch.int32), torch.gather(d2, 1, order), order


def test_fallback_matches_jax(tnative):
    """The fallback lists of vertices and of triangle centroids as the JAX
    package computes them, with edge padding past the number of items,
    on a UV-atlased icosphere too (its duplicated seam vertices tie)."""
    m = _noisy(jmesh.make_icosphere(2, radius=0.5), seed=3)
    cent = m.vertices[m.faces].mean(1)
    for pts in (m.vertices, cent, m.vertices[:3], m.vertices[:1],
                _atlas()):
        lo, cs = _grid(pts, 12)
        got = tnative.build_fallback(tnative.kdtree(pts, "cpu"), 12, lo, cs,
                                     8)
        want = jspatial._build_fallback(pts, lo, cs, 12, 8)
        assert got.dtype == torch.int32 and got.shape == (12 ** 3, 8)
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tnative.cell_centres(12, lo, cs, "cpu").numpy(),
        (np.stack(np.meshgrid(*[np.arange(12)] * 3, indexing="ij"), -1)
         .reshape(-1, 3) + 0.5) * cs + lo)


def test_kdtree_layout(tnative):
    """``kdtree``'s nodes: every point in exactly one leaf, children after
    their parent, a child's rect its parent's cut at the split."""
    pts = np.random.default_rng(2).uniform(-1, 1, (3000, 3))
    tree = tnative.kdtree(pts, "cpu")
    nodes, splits, rects = (tree.nodes.numpy(), tree.splits.numpy(),
                            tree.rects.numpy())
    leaves = nodes[nodes[:, 0] == -1]
    covered = np.concatenate([np.arange(a, b) for _, a, b, _ in leaves])
    np.testing.assert_array_equal(np.sort(covered), np.arange(len(pts)))
    np.testing.assert_array_equal(rects[0], np.r_[pts.min(0), pts.max(0)])
    for i in np.flatnonzero(nodes[:, 0] >= 0):
        d, le, gr, _ = nodes[i]
        assert i < le < gr
        np.testing.assert_array_equal(rects[le][np.arange(6) != 3 + d],
                                      rects[i][np.arange(6) != 3 + d])
        np.testing.assert_array_equal(rects[gr][np.arange(6) != d],
                                      rects[i][np.arange(6) != d])
        assert rects[le][3 + d] == splits[i] == rects[gr][d]


def test_native_module_names(tnative):
    """The JAX module's public names, the launch counts at 0 on the CPU
    path, and tables on the device of the input."""
    for name in ("available", "build_vertex_grid", "build_triangle_grid",
                 "kdtree", "build_fallback"):
        assert callable(getattr(tnative, name))
    m = jmesh.make_icosphere(1, radius=0.5)
    lo, cs = _grid(m.vertices, 8)
    before = (tnative.build_vertex_grid.launches,
              tnative.build_triangle_grid.launches,
              tnative.build_fallback.launches)
    t = tnative.build_vertex_grid(torch.as_tensor(m.vertices), 8, lo, cs, 4)
    assert t.device.type == "cpu" and t.dtype == torch.int32
    tnative.build_fallback(tnative.kdtree(m.vertices, "cpu"), 8, lo, cs, 8)
    assert (tnative.build_vertex_grid.launches,
            tnative.build_triangle_grid.launches,
            tnative.build_fallback.launches) == before
