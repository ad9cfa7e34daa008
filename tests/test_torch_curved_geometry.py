"""The curved model's geometry in the PyTorch port vs the JAX package:
the host mesh pieces, the grid index and kNN, the kNN normal, the
seeded anchor frames and the per-cell anchor table.

Tolerances, each with its reason:
- the host mesh (icosphere, normals, edges, UV atlas, TBN frames) and
  the projector's host arrays: equal (the same numpy statements);
- knn: indices exact, distances within 1e-6 (the same f32 distance
  chain; the two packages build the cell lists with different builders,
  so the padded tables are not compared, what knn returns is).  XLA may
  fuse the distance sum into multiply-adds, so two neighbours whose
  distances tie to the last bit on one side can differ by an ulp on the
  other and swap places: indices may differ only by a permutation
  within such a group of equal (to 1e-6) distances;
- knn_normal, seed_anchor_frames, the anchor table: within 1e-5 (f32
  sums of up to 9 weighted unit vectors, normalised twice), hit exact.
  A frame's TBN is that of its nearest vertex, so where two vertices tie
  for nearest (above) the two TBNs may differ: each must then be the TBN
  of a vertex tied for nearest, and such query points stay under 1%.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_texture_tpu.geometry import mesh as jmesh
from nerf_texture_tpu.geometry import projector as jproj
from nerf_texture_tpu.geometry import spatial as jspatial
from nerf_texture_tpu_torch.geometry import mesh as tmesh
from nerf_texture_tpu_torch.geometry import projector as tproj
from nerf_texture_tpu_torch.geometry import spatial as tspatial

GRID = 16
MAX_DIST = 4.0 * 0.12 + 2.0 * (2.0 / GRID)   # the trainer's anchor gate


@pytest.fixture(scope="module")
def projectors():
    m_j = jmesh.make_icosphere(2, radius=0.5)
    m_t = tmesh.make_icosphere(2, radius=0.5)
    return jproj.MeshProjector(m_j), tproj.MeshProjector(m_t, device="cpu")


def _np(a):
    return a.numpy() if torch.is_tensor(a) else np.asarray(a)


def _assert_same_neighbours(i_t, d_t, i_j, d_j):
    """Exact indices, distances within 1e-6, except that neighbours at
    equal distance (within 1e-6) may come in either order."""
    i_t, d_t, i_j, d_j = _np(i_t), _np(d_t), np.asarray(i_j), np.asarray(d_j)
    np.testing.assert_allclose(d_t, d_j, rtol=0, atol=1e-6)
    for row in np.where((i_t != i_j).any(-1))[0]:
        for a in np.where(i_t[row] != i_j[row])[0]:
            tie = np.abs(d_j[row] - d_j[row, a]) <= 1e-6
            assert i_t[row, a] in set(i_j[row, tie]), (row, a)
    assert np.mean((i_t != i_j).any(-1)) < 0.01


def _assert_frames_match(f_t, f_j, queries, pt):
    """Frames (dicts of p0, normal, tbn, hit) of the query points agree;
    see the module docstring for the TBN of a tied nearest vertex."""
    np.testing.assert_array_equal(_np(f_t["hit"]), np.asarray(f_j["hit"]))
    for k in ("p0", "normal"):
        np.testing.assert_allclose(_np(f_t[k]), np.asarray(f_j[k]), rtol=0,
                                   atol=1e-5, err_msg=k)
    tb_t, tb_j = _np(f_t["tbn"]), np.asarray(f_j["tbn"])
    off = np.where(np.abs(tb_t - tb_j).reshape(len(tb_t), -1).max(-1)
                   > 1e-5)[0]
    # (a collapsed table copies one tied row down its column: count the
    # distinct query points)
    assert len(np.unique(queries[off], axis=0)) <= 0.01 * len(tb_t)
    if not len(off):
        return
    d, i = tspatial.knn(pt.arrays.vgrid, pt.arrays.vertices,
                        torch.as_tensor(queries[off]), k=8, stencil="faces")
    vtbn = _np(pt.arrays.vertex_tbn)
    for r, dr, ir in zip(off, _np(d), _np(i)):
        tied = vtbn[ir[dr <= dr[0] + 1e-6]]
        for tb in (tb_t[r], tb_j[r]):
            assert np.abs(tied - tb).reshape(len(tied), -1).max(-1).min() \
                <= 1e-5, r


def _table_frames(tab):
    rows = _np(tab).reshape(-1, 16)
    return {"p0": rows[:, 0:3], "normal": rows[:, 3:6],
            "tbn": rows[:, 6:15].reshape(-1, 3, 3), "hit": rows[:, 15] > 0.5}


def _points(n, seed):
    """Points on, near and far from the r = 0.5 sphere, plus the corners
    of the grid's box."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    r = 0.5 + rng.uniform(-0.15, 0.15, n)
    r[: n // 8] = rng.uniform(0.0, 1.7, n // 8)
    pts = np.clip(d * r[:, None], -1.0, 1.0)
    pts[:8] = np.array(np.meshgrid([-1, 1], [-1, 1], [-1, 1])).reshape(3, 8).T
    return pts.astype(np.float32)


@pytest.mark.parametrize("subdiv", [1, 2, 3])
def test_host_mesh_mirrors_jax(subdiv):
    a = tmesh.make_icosphere(subdiv, radius=0.5)
    b = jmesh.make_icosphere(subdiv, radius=0.5)
    np.testing.assert_array_equal(a.vertices, b.vertices)
    np.testing.assert_array_equal(a.faces, b.faces)
    np.testing.assert_array_equal(a.face_normals, b.face_normals)
    np.testing.assert_array_equal(a.vertex_normals, b.vertex_normals)
    np.testing.assert_array_equal(a.edges_unique, b.edges_unique)
    assert a.mean_edge_length == b.mean_edge_length
    ua, ub = tmesh.uv_atlas(a), jmesh.uv_atlas(b)
    np.testing.assert_array_equal(ua.vertices, ub.vertices)
    np.testing.assert_array_equal(ua.faces, ub.faces)
    np.testing.assert_array_equal(ua.uvs, ub.uvs)
    np.testing.assert_array_equal(tmesh.calculate_tbn(ua, ua.uvs),
                                  jmesh.calculate_tbn(ub, ub.uvs))


def test_projector_arrays_mirror_jax(projectors):
    pj, pt = projectors
    a, b = pt.arrays, pj.arrays
    for name in ("vertices", "vertex_normals", "faces", "face_tbn", "uvs",
                 "vertex_tbn"):
        np.testing.assert_array_equal(_np(getattr(a, name)),
                                      np.asarray(getattr(b, name)),
                                      err_msg=name)
    assert pt.mean_edge_length == pj.mean_edge_length
    for g_t, g_j in ((a.vgrid, b.vgrid), (a.tgrid, b.tgrid)):
        assert g_t.res == g_j.res
        np.testing.assert_array_equal(_np(g_t.origin), np.asarray(g_j.origin))
        assert float(g_t.cell_size) == float(g_j.cell_size)
        np.testing.assert_array_equal(_np(g_t.fallback),
                                      np.asarray(g_j.fallback))
        # the same items per cell, whatever the builder's order
        ct, cj = _np(g_t.cell_items), np.asarray(g_j.cell_items)
        np.testing.assert_array_equal(np.sort(ct, -1), np.sort(cj, -1))


@pytest.mark.parametrize("stencil", ["full", "faces"])
def test_knn_matches(projectors, stencil):
    pj, pt = projectors
    pts = _points(2000, 0)
    d_t, i_t = tspatial.knn(pt.arrays.vgrid, pt.arrays.vertices,
                            torch.from_numpy(pts), k=8, stencil=stencil)
    d_j, i_j = jspatial.knn(pj.arrays.vgrid, pj.arrays.vertices,
                            jnp.asarray(pts), k=8, stencil=stencil)
    _assert_same_neighbours(i_t, d_t, i_j, d_j)
    assert (np.diff(_np(d_t), axis=-1) >= 0).all()


def test_knn_breaks_ties_by_lower_id():
    # four vertices at the same distance from the query, in any id order
    verts = np.array([[1, 0, 0], [0, 1, 0], [-1, 0, 0], [0, -1, 0],
                      [0, 0, 3], [0, 0, -3]], np.float64)
    perm = np.array([3, 5, 0, 4, 1, 2])
    g = tspatial.build_grid(verts[perm], 2, 8, device="cpu")
    d, i = tspatial.knn(g, torch.as_tensor(verts[perm], dtype=torch.float32),
                        torch.zeros((1, 3)), k=4)
    inv = np.argsort(perm)
    np.testing.assert_array_equal(_np(i)[0], np.sort(inv[:4]))
    np.testing.assert_allclose(_np(d)[0], 1.0)


def test_knn_normal_and_seed_frames_match(projectors):
    pj, pt = projectors
    pts = _points(1500, 1)
    valid = np.random.default_rng(2).uniform(size=len(pts)) < 0.9
    n_t, dv_t, i_t, dis_t = tproj.knn_normal(pt.arrays, torch.from_numpy(pts))
    n_j, dv_j, i_j, dis_j = jproj.knn_normal(pj.arrays, jnp.asarray(pts))
    _assert_same_neighbours(i_t, dis_t[:, :8], i_j, dis_j[:, :8])
    for a, b in ((n_t, n_j), (dis_t, dis_j)):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=0, atol=1e-5)
    f_t = tproj.seed_anchor_frames(pt.arrays, torch.from_numpy(pts),
                                   torch.from_numpy(valid), k=8,
                                   max_dist=MAX_DIST)
    f_j = jproj.seed_anchor_frames(pj.arrays, jnp.asarray(pts),
                                   jnp.asarray(valid), k=8,
                                   max_dist=MAX_DIST)
    assert 0 < _np(f_t["hit"]).sum() < len(pts)
    _assert_frames_match(f_t, f_j, pts, pt)


@pytest.mark.parametrize("collapse", [True, False])
def test_anchor_table_matches(projectors, collapse):
    pj, pt = projectors
    tab_t = tproj.build_anchor_table(pt.arrays, GRID, 1.0, k=8,
                                     max_dist=MAX_DIST, chunk=1000,
                                     collapse_columns=collapse)
    tab_j = jproj.build_anchor_table(pj.arrays, GRID, 1.0, k=8,
                                     max_dist=MAX_DIST, chunk=1000,
                                     collapse_columns=collapse)
    a, b = _np(tab_t), np.asarray(tab_j)
    assert a.shape == b.shape == (GRID, GRID, GRID, 16)
    assert 0 < a[..., 15].sum() < GRID ** 3
    c = (np.arange(GRID, dtype=np.float64) + 0.5) / GRID * 2.0 - 1.0
    centers = np.stack(np.meshgrid(c, c, c, indexing="ij"), -1).reshape(-1, 3)
    src = centers
    if collapse:
        # each row came from the cell holding its p0: query that cell
        cell = np.clip(((a.reshape(-1, 16)[:, :3] + 1.0) * (GRID / 2.0))
                       .astype(np.int64), 0, GRID - 1)
        src = centers[(cell[:, 0] * GRID + cell[:, 1]) * GRID + cell[:, 2]]
    _assert_frames_match(_table_frames(a), _table_frames(b),
                         src.astype(np.float32), pt)
    # skipped cells keep the safe identity frame (unit +z normal)
    far = a[0, 0, 0]
    np.testing.assert_array_equal(far[3:6], [0, 0, 1])
    np.testing.assert_array_equal(far[6:15].reshape(3, 3), np.eye(3))

    pts = _points(3000, 3)
    valid = np.ones(len(pts), bool)
    f_t = tproj.anchor_frames_from_table(tab_t, torch.from_numpy(pts),
                                         torch.from_numpy(valid), 1.0)
    f_j = jproj.anchor_frames_from_table(tab_j, jnp.asarray(pts),
                                         jnp.asarray(valid), 1.0)
    for k in ("p0", "normal", "tbn", "hit"):
        np.testing.assert_array_equal(
            _np(f_t[k]), _table_frames(a)[k][_cells(pts)], err_msg=k)
        np.testing.assert_array_equal(
            np.asarray(f_j[k]), _table_frames(b)[k][_cells(pts)], err_msg=k)


def _cells(pts):
    """Flat table cells of points in [-1, 1] (truncation toward zero)."""
    c = np.clip(((pts + 1.0) * (GRID / 2.0)).astype(np.int32), 0, GRID - 1)
    return (c[:, 0] * GRID + c[:, 1]) * GRID + c[:, 2]


def test_anchor_lookup_truncates_at_the_boundary():
    tab = torch.arange(2 * 2 * 2 * 16, dtype=torch.float32).reshape(2, 2, 2,
                                                                  16)
    x = torch.tensor([[-1.0, -1.0, 1.0], [0.0, -0.0, 0.999999],
                      [-1e-8, 0.0, 0.0]])
    f = tproj.anchor_frames_from_table(tab, x, torch.ones(3, dtype=bool), 1.0)
    f_j = jproj.anchor_frames_from_table(jnp.asarray(tab.numpy()),
                                         jnp.asarray(x.numpy()),
                                         jnp.ones(3, bool), 1.0)
    np.testing.assert_array_equal(_np(f["p0"]), np.asarray(f_j["p0"]))


def test_unported_queries_raise(projectors):
    """The queries of the exact projection, unported until item 7, now
    run on the projector (their parity with the JAX package:
    tests/test_torch_projection.py); none of them raises."""
    _, pt = projectors
    a = pt.arrays
    x = torch.tensor([[0.0, 0.0, 0.55], [0.3, -0.4, 0.1]])
    assert tproj.project(a, x)[0].shape == (2, 3)
    assert tproj.uvh(a, x)[0].shape == (2, 3)
    assert tproj.weighted_project(a, x)[0].shape == (2, 1)
    assert tproj.barycentric_mapping(a, x, tproj.knn_normal(a, x)[0])[1] \
        .shape == (2, 3)
    assert tproj.diff_project(x, x, x[:, :1], x)[0] is not x
    assert tspatial.raycast(a.tgrid, a.vertices, a.faces, x,
                            -x)[2].shape == (2,)
    assert tspatial.nearest_face(a.tgrid, a.vertices, a.faces,
                                 x)[0].shape == (2,)
