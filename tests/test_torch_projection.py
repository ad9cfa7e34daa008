"""The exact projection of the PyTorch port vs the JAX package: the
triangle primitives, the DDA ray cast and the nearest-face query over the
triangle grid, the kNN normal's options, ``project``,
``weighted_project``, ``barycentric_mapping``, ``uvh``, ``query_tbn``,
``signed_distance``, ``pointcloud_arrays``, ``diff_project``'s gradient,
and the mesh field in mode 'none' without anchor frames (the field and
one grid refresh through the exact projection).

Meshes: the JAX package's analytic ones (``make_box``, ``make_plane``,
``make_icosphere``), built by each package from its own mirror.  The JAX
functions run on the port's vertex and triangle grid tables: the JAX
package builds its cell lists with a C++ helper in f32 where g++ is
present, and a triangle on a cell border can then land in another list,
which changes the candidates, not the functions under test.

Tolerances, each with its reason:
- hit / miss and face ids exactly; depths, positions, normals, heights
  and barycentrics within 1e-6 (the same f32 formulas; XLA may fuse a
  multiply-add), but for <= 0.5% of the rays, which stay within 1e-4: a
  grazing hit divides by a small determinant, which amplifies a last-bit
  difference (measured: 3 of 3000 rays on the icosphere, 1.0e-6 to
  3.2e-5).  Where two triangles tie -- a hit or a closest point
  within 1e-6 of a shared edge -- either package may name either face
  (the two packages fill a cell's face list in different code);
  the other face must then hold the same point within 1e-6.  The kNN
  neighbours follow ``tests/test_torch_curved_geometry.py``;
- ``diff_project``'s gradient within 1e-6 (the same formula);
- the field in mode 'none': the bounds of test_torch_curved_field.py
  (features 2e-2 of their largest entry with bf16 rows, normals 1e-2,
  masks exact); the refresh
  with JAX's jitter: masks exact, densities within 1e-5 (relative) for
  >= 99% of cells.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_texture_tpu.data.synthetic import SyntheticSphereDataset
from nerf_texture_tpu.geometry import mesh as jmesh
from nerf_texture_tpu.geometry import projector as jproj
from nerf_texture_tpu.geometry import spatial as jspatial
from nerf_texture_tpu.geometry import triangle as jtri
from nerf_texture_tpu.models import curved_field as jcf
from nerf_texture_tpu.models import mesh_field as jmf
from nerf_texture_tpu.ops import occupancy as jocc
from nerf_texture_tpu.render import renderer as jr
from nerf_texture_tpu.train import curved_trainer as jct
from nerf_texture_tpu_torch.convert import params_from_jax
from nerf_texture_tpu_torch.geometry import mesh as tmesh
from nerf_texture_tpu_torch.geometry import projector as tproj
from nerf_texture_tpu_torch.geometry import spatial as tspatial
from nerf_texture_tpu_torch.geometry import triangle as ttri
from nerf_texture_tpu_torch.models import curved_field as tcf
from nerf_texture_tpu_torch.models import mesh_field as tmf
from nerf_texture_tpu_torch.ops import occupancy as tocc
from nerf_texture_tpu_torch.render.renderer import RenderConfig
from nerf_texture_tpu_torch.train import curved_trainer as tct

TOL = 1e-6
MESHES = {
    "box": lambda m: m.make_box((0.4, 0.3, 0.5)),
    "plane": lambda m: m.make_plane(8, 0.6),
    "icosphere": lambda m: m.make_icosphere(2, radius=0.5),
}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The ray cast and the kNN run many small tensor ops: beside
    pytest-xdist's other workers, a full intra-op thread pool makes each
    of them wait on the busy cores (this file took ~10x its time alone
    in a 6-worker run).  Two threads a worker for this module."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np(a):
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _t(a, dtype=None):
    return torch.tensor(np.asarray(a), dtype=dtype)


def _jax_grid(g):
    """The port's GridIndex as the JAX package's."""
    return jspatial.GridIndex(
        cell_items=jnp.asarray(_np(g.cell_items), jnp.int32),
        fallback=jnp.asarray(_np(g.fallback), jnp.int32),
        origin=jnp.asarray(_np(g.origin)),
        cell_size=jnp.asarray(_np(g.cell_size)), res=g.res)


class _Arrays:
    """A JAX MeshProjector's ``arrays`` on the port's grid tables."""

    def __init__(self, arrays):
        self.arrays = arrays


@pytest.fixture(scope="module", params=list(MESHES))
def meshes(request):
    """(name, JAX projector on the port's grids, port MeshProjector)."""
    name = request.param
    pt = tproj.MeshProjector(MESHES[name](tmesh), device="cpu")
    arrays = jproj.MeshProjector(MESHES[name](jmesh)).arrays._replace(
        vgrid=_jax_grid(pt.arrays.vgrid), tgrid=_jax_grid(pt.arrays.tgrid))
    return name, _Arrays(arrays), pt


def _surface_points(pt, n, spread, seed):
    """Points within +-spread of the mesh along its vertex normals."""
    rng = np.random.default_rng(seed)
    m = pt.mesh
    f = rng.integers(0, len(m.faces), n)
    w = rng.dirichlet([1.0, 1.0, 1.0], n)
    tri = m.vertices[m.faces[f]]
    p = np.einsum("nk,nkd->nd", w, tri)
    nrm = m.face_normals[f]
    return (p + nrm * rng.uniform(-spread, spread, (n, 1))).astype(
        np.float32)


def _rays(pt, n, seed):
    """Rays from outside the mesh toward points near it, and a share of
    random directions (misses)."""
    rng = np.random.default_rng(seed)
    target = _surface_points(pt, n, 0.02, seed)
    o = rng.normal(size=(n, 3))
    o = o / np.linalg.norm(o, axis=-1, keepdims=True) * 1.2
    d = target - o
    d[: n // 5] = rng.normal(size=(n // 5, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _close(got, want, tol=TOL, share=0.995, cap=1e-4):
    """Within tol on >= share of the rows, within cap on all."""
    err = np.abs(np.asarray(got) - np.asarray(want))
    err = err.reshape(len(err), -1).max(-1)
    assert (err <= tol).mean() >= share, np.sort(err)[-10:]
    assert err.max() <= cap, err.max()


def _on_face(pa, points, faces):
    """Distance from points [Q, 3] to faces [Q] of port arrays pa."""
    v = pa.vertices[pa.faces[_t(faces, torch.int64)]]
    d2, _, _ = ttri.point_triangle_closest(_t(points), v[:, 0], v[:, 1],
                                           v[:, 2])
    return np.sqrt(_np(d2))


def _assert_faces(pa, points, f_t, f_j, max_share=0.01):
    """Face ids equal but at ties: the other face holds the point."""
    diff = (f_t != f_j) & (f_j >= 0)
    assert diff.mean() <= max_share, diff.mean()
    if diff.any():
        assert _on_face(pa, points[diff], f_j[diff]).max() <= TOL
    return diff


def _assert_nearest(pa, x, got, want):
    """nearest_face results (udf, face, bary, closest): the distance
    within TOL; where the faces differ, the distances tie (the JAX face is
    as near to the query), else closest points and barycentrics within
    TOL."""
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=TOL)
    diff = got[1] != want[1]
    assert diff.mean() <= 0.01, diff.mean()
    if diff.any():
        np.testing.assert_allclose(_on_face(pa, x[diff], want[1][diff]),
                                   got[0][diff], rtol=0, atol=TOL)
    np.testing.assert_allclose(got[3][~diff], want[3][~diff], rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(got[2][~diff], want[2][~diff], rtol=0,
                               atol=TOL)


def test_triangle_primitives_match():
    rng = np.random.default_rng(0)
    n = 500
    v0, v1, v2 = (rng.normal(size=(n, 3)).astype(np.float32)
                  for _ in range(3))
    o = rng.normal(size=(n, 3)).astype(np.float32) * 2
    c = (v0 + v1 + v2) / 3
    d = c - o + rng.normal(size=(n, 3)).astype(np.float32) * 0.3
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_t, h_t = ttri.moller_trumbore(*map(_t, (o, d, v0, v1, v2)))
    t_j, h_j = jtri.moller_trumbore(*map(jnp.asarray, (o, d, v0, v1, v2)))
    np.testing.assert_array_equal(_np(h_t), np.asarray(h_j))
    assert 0.2 < _np(h_t).mean() < 0.95
    np.testing.assert_allclose(_np(t_t), np.asarray(t_j), rtol=TOL, atol=TOL)
    p = rng.normal(size=(n, 3)).astype(np.float32)
    for a, b in zip(ttri.point_triangle_closest(*map(_t, (p, v0, v1, v2))),
                    jtri.point_triangle_closest(*map(jnp.asarray,
                                                     (p, v0, v1, v2)))):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=TOL,
                                   atol=TOL)
    tris = np.stack([v0, v1, v2], 1)
    np.testing.assert_allclose(
        _np(ttri.points_to_barycentric(_t(tris), _t(c))),
        np.asarray(jtri.points_to_barycentric(jnp.asarray(tris),
                                              jnp.asarray(c))),
        rtol=TOL, atol=TOL)


def test_raycast_matches(meshes):
    name, pj, pt = meshes
    a, b = pt.arrays, pj.arrays
    o, d = _rays(pt, 3000, 1)
    got = tspatial.raycast(a.tgrid, a.vertices, a.faces, _t(o), _t(d))
    want = jspatial.raycast(b.tgrid, b.vertices, b.faces, jnp.asarray(o),
                            jnp.asarray(d))
    pos_t, n_t, d_t, f_t = map(_np, got)
    pos_j, n_j, d_j, f_j = map(np.asarray, want)
    np.testing.assert_array_equal(d_t < 9.5, d_j < 9.5)
    assert 0.3 < (d_j < 9.5).mean() < 0.95, (d_j < 9.5).mean()
    np.testing.assert_array_equal(f_t < 0, f_j < 0)
    _close(d_t, d_j)
    _close(pos_t, pos_j)
    diff = _assert_faces(a, pos_t, f_t, f_j)
    np.testing.assert_allclose(n_t[~diff], n_j[~diff], rtol=0, atol=TOL)
    # a short walk from far away misses what the full walk finds
    short = tspatial.raycast(a.tgrid, a.vertices, a.faces, _t(o), _t(d),
                             max_steps=1)
    short_j = jspatial.raycast(b.tgrid, b.vertices, b.faces, jnp.asarray(o),
                               jnp.asarray(d), max_steps=1)
    np.testing.assert_array_equal(_np(short[3]) >= 0,
                                  np.asarray(short_j[3]) >= 0)
    assert (_np(short[3]) >= 0).sum() < (f_t >= 0).sum()


def test_nearest_face_matches(meshes):
    name, pj, pt = meshes
    a, b = pt.arrays, pj.arrays
    x = _surface_points(pt, 2000, 0.15, 2)
    got = [_np(v) for v in tspatial.nearest_face(a.tgrid, a.vertices,
                                                 a.faces, _t(x))]
    want = [np.asarray(v) for v in jspatial.nearest_face(
        b.tgrid, b.vertices, b.faces, jnp.asarray(x))]
    _assert_nearest(a, x, got, want)


KNN_OPTIONS = [
    dict(),
    dict(use_dir_vec=False, weighting="DualD", nn_consis_check=True),
    dict(use_dir_vec=False, weighting="Gaussian", gaussian_factor=-50.0),
    dict(weighting="DualD", direct_above_check=True,
         direct_above_threshold=0.05),
    dict(use_dir_vec=False, direct_above_check=True,
         direct_above_threshold=1.0, stencil="full"),
]


@pytest.mark.parametrize("opts", KNN_OPTIONS)
def test_knn_normal_options_match(meshes, opts):
    name, pj, pt = meshes
    x = _surface_points(pt, 1500, 0.1, 3)
    got = [_np(v) for v in tproj.knn_normal(pt.arrays, _t(x), **opts)]
    want = [np.asarray(v) for v in jproj.knn_normal(pj.arrays,
                                                    jnp.asarray(x), **opts)]
    same = np.all(got[2] == want[2], -1)
    assert same.mean() >= 0.99, same.mean()
    for g, w in zip((got[0], got[1], got[3]), (want[0], want[1], want[3])):
        np.testing.assert_allclose(g[same], w[same], rtol=0, atol=1e-5)


def test_project_matches(meshes):
    name, pj, pt = meshes
    x = _surface_points(pt, 2000, 0.12, 4)
    got = [_np(v) for v in tproj.project(pt.arrays, _t(x), h_threshold=0.1)]
    want = [np.asarray(v) for v in jproj.project(pj.arrays, jnp.asarray(x),
                                                 h_threshold=0.1)]
    p_t, s_t, m_t, n_t, tbn_t = got
    p_j, s_j, m_j, n_j, tbn_j = want
    np.testing.assert_array_equal(m_t, m_j)
    assert 0.3 < m_j.mean() < 1.0
    np.testing.assert_allclose(n_t, n_j, rtol=0, atol=1e-5)
    np.testing.assert_allclose(s_t, s_j, rtol=0, atol=1e-5)
    np.testing.assert_allclose(p_t, p_j, rtol=0, atol=1e-5)
    same = np.all(np.abs(tbn_t - tbn_j) <= TOL, axis=(-1, -2))
    assert same.mean() >= 0.99


@pytest.mark.parametrize("weighting", ["DualD", "Shepard", "Gaussian"])
def test_weighted_project_matches(meshes, weighting):
    name, pj, pt = meshes
    x = _surface_points(pt, 1500, 0.1, 5)
    kw = dict(weighting=weighting, gaussian_factor=-20.0, sdf_scale=0.5,
              sdf_offset=0.01, direct_above_check=weighting == "DualD",
              direct_above_threshold=1.0)
    got = [_np(v) for v in tproj.weighted_project(pt.arrays, _t(x), **kw)]
    want = [np.asarray(v) for v in jproj.weighted_project(
        pj.arrays, jnp.asarray(x), **kw)]
    same = np.all(got[1] == want[1], -1)
    assert same.mean() >= 0.99
    for g, w in zip(got, want):
        np.testing.assert_allclose(g[same], w[same], rtol=0, atol=1e-5)
    got = tproj.weighted_project(pt.arrays, _t(x), return_psur=True, **kw)
    want = jproj.weighted_project(pj.arrays, jnp.asarray(x),
                                  return_psur=True, **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g)[same], np.asarray(w)[same],
                                   rtol=0, atol=1e-5)


def test_barycentric_uvh_tbn_and_signed_distance_match(meshes):
    name, pj, pt = meshes
    x = _surface_points(pt, 1500, 0.25, 6)
    xt, xj = _t(x), jnp.asarray(x)
    normal = tproj.knn_normal(pt.arrays, xt)[0]
    kw = dict(h_threshold=0.08, sdf_scale=2.0, sdf_offset=0.01)
    got = [_np(v) for v in tproj.barycentric_mapping(pt.arrays, xt, normal,
                                                     **kw)]
    want = [np.asarray(v) for v in jproj.barycentric_mapping(
        pj.arrays, xj, jnp.asarray(_np(normal)), **kw)]
    np.testing.assert_array_equal(got[3], want[3])
    assert 0.2 < want[3].mean() < 1.0
    np.testing.assert_allclose(got[2], want[2], rtol=0, atol=1e-5)
    diff = got[4] != want[4]
    assert diff.mean() <= 0.01
    np.testing.assert_array_equal(got[0][~diff], want[0][~diff])
    np.testing.assert_allclose(got[1][~diff], want[1][~diff], rtol=0,
                               atol=1e-5)
    u_t = [_np(v) for v in tproj.uvh(pt.arrays, xt, **kw)]
    u_j = [np.asarray(v) for v in jproj.uvh(pj.arrays, xj, **kw)]
    np.testing.assert_array_equal(u_t[1], u_j[1])
    np.testing.assert_allclose(u_t[2], u_j[2], rtol=0, atol=1e-5)
    ok = np.all(np.abs(u_t[3] - u_j[3]) <= TOL, axis=(-1, -2))
    assert ok.mean() >= 0.99
    np.testing.assert_allclose(u_t[0][ok], u_j[0][ok], rtol=0, atol=1e-5)
    q_t = [_np(v) for v in tproj.query_tbn(pt.arrays, xt, **kw)]
    q_j = [np.asarray(v) for v in jproj.query_tbn(pj.arrays, xj, **kw)]
    np.testing.assert_array_equal(q_t[1], q_j[1])
    ok = np.all(np.abs(q_t[0] - q_j[0]) <= TOL, axis=(-1, -2))
    assert ok.mean() >= 0.99
    s_t = [_np(v) for v in tproj.signed_distance(pt.arrays, xt)]
    s_j = [np.asarray(v) for v in jproj.signed_distance(pj.arrays, xj)]
    assert (s_j[0] < 0).any() and (s_j[0] > 0).any()
    np.testing.assert_array_equal(s_t[0] < 0, s_j[0] < 0)
    _assert_nearest(pt.arrays, x, [np.abs(s_t[0])] + s_t[1:],
                    [np.abs(s_j[0])] + s_j[1:])


def test_pointcloud_arrays_match():
    rng = np.random.default_rng(7)
    pts = rng.uniform(-0.3, 0.3, (400, 3)) * [1, 1, 0.02]
    nrm = np.tile([[0.0, 0.0, 1.0]], (400, 1))
    a = tproj.pointcloud_arrays(pts, nrm, device="cpu")
    b = jproj.pointcloud_arrays(pts, nrm)
    for name in ("vertices", "vertex_normals", "faces", "face_tbn", "uvs",
                 "vertex_tbn"):
        np.testing.assert_array_equal(_np(getattr(a, name)),
                                      np.asarray(getattr(b, name)))
    np.testing.assert_array_equal(_np(a.vgrid.fallback),
                                  np.asarray(b.vgrid.fallback))
    assert a.vgrid.res == b.vgrid.res
    # the patch import's query on it
    x = (rng.uniform(-0.25, 0.25, (800, 3)) * [1, 1, 0.3]).astype(np.float32)
    kw = dict(k=8, direct_above_check=True, direct_above_threshold=1.0)
    got = [_np(v) for v in tproj.weighted_project(a, _t(x), **kw)]
    want = [np.asarray(v) for v in jproj.weighted_project(
        b, jnp.asarray(x), **kw)]
    same = np.all(got[1] == want[1], -1)
    assert same.mean() >= 0.99
    for g, w in zip(got, want):
        np.testing.assert_allclose(g[same], w[same], rtol=0, atol=1e-5)


def test_diff_project_gradient_matches_jax_vjp():
    rng = np.random.default_rng(8)
    n = 300
    xyz, p_sur, normal = (rng.normal(size=(n, 3)).astype(np.float32)
                          for _ in range(3))
    sdf = rng.normal(size=(n, 1)).astype(np.float32)
    g = [rng.normal(size=s).astype(np.float32)
         for s in ((n, 3), (n, 3), (n, 1), (n, 3))]
    outs, vjp = jax.vjp(jproj.diff_project, *map(jnp.asarray,
                                                 (xyz, p_sur, sdf, normal)))
    want = vjp(tuple(map(jnp.asarray, g)))
    ins = [_t(a).requires_grad_(True) for a in (xyz, p_sur, sdf, normal)]
    got = tproj.diff_project(*ins)
    for a, b in zip(got, outs):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    torch.autograd.backward(got, [_t(a) for a in g])
    for a, b in zip(ins, want):
        np.testing.assert_allclose(_np(a.grad), np.asarray(b), rtol=0,
                                   atol=TOL)
    # only the surface point and the height route into xyz
    x = _t(xyz).requires_grad_(True)
    _, ps, sd, _ = tproj.diff_project(x, _t(p_sur), _t(sdf), _t(normal))
    (ps.sum() + sd.sum()).backward()
    n_ = normal / (np.linalg.norm(normal, axis=-1, keepdims=True) + 1e-5)
    ones = np.ones((n, 3), np.float32)
    want_x = ones - n_ * np.sum(n_ * ones, -1, keepdims=True) + n_
    np.testing.assert_allclose(_np(x.grad), want_x, rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# the field in mode 'none' without anchor frames
# ---------------------------------------------------------------------------

FIELD = dict(num_levels=3, level_dim=2, base_resolution=16,
             desired_resolution=32, log2_bricks=9, h_threshold=0.12,
             clustering=False)
MODEL = dict(light_model="SH", hidden_dim=16, geo_feat_dim=7)
RENDER = dict(bound=1.0, cascades=1, grid_size=16, max_steps=48,
              max_samples_train=24, max_samples_infer=32, ray_chunk=256,
              pool_mean_samples=16, pool_mean_samples_infer=16,
              proxy_samples=0)


@pytest.fixture(scope="module")
def field_setup():
    cj = jcf.CurvedFieldConfig(field=jmf.MeshFieldConfig(**FIELD), **MODEL)
    ct = tcf.CurvedFieldConfig(field=tmf.MeshFieldConfig(**FIELD), **MODEL)
    rj = jr.RenderConfig(**RENDER)
    tj = jct.CurvedTrainer(SyntheticSphereDataset(n_frames=2, H=16, W=16),
                           jmf.make_state(jproj.MeshProjector(
                               jmesh.make_icosphere(2, radius=0.5))),
                           cj, rj, jct.CurvedTrainConfig(),
                           key=jax.random.PRNGKey(0))
    p = jax.tree.map(np.array, tj.state.params)
    rw = cj.field.feature_spec.row_width
    p["field"]["encoder"][:, :rw] *= 1e4
    p["field"]["normal"]["phi_grid"] *= 1e3
    mp = tproj.MeshProjector(tmesh.make_icosphere(2, radius=0.5),
                             device="cpu")
    return dict(mp=mp, st=tmf.make_state(mp), cj=cj, ct=ct, rj=rj, rt=RenderConfig(**dataclasses.asdict(rj)),
                tj=tj, p=p, pj=jax.tree.map(jnp.asarray, p),
                pt=params_from_jax(p, device="cpu"))


@pytest.mark.parametrize("noisy", [False, True])
def test_mesh_field_without_frames_matches(field_setup, noisy):
    s = field_setup
    fj, ft = s["cj"].field, s["ct"].field
    x = _surface_points(s["mp"], 1500, 0.15, 9)
    key = jax.random.PRNGKey(11)
    out_j = jmf.apply(s["pj"]["field"], s["tj"].field_state, jnp.asarray(x),
                      fj, key=key if noisy else None, no_noise=not noisy,
                      requires_grad_xyz=noisy)
    noise = _t(jax.random.normal(key, (len(x), fj.encoder_f_out_dim))) \
        if noisy else None
    out_t = tmf.apply(s["pt"]["field"], s["st"], _t(x), ft, noise=noise,
                      no_noise=not noisy, requires_grad_xyz=noisy)
    np.testing.assert_array_equal(_np(out_t.h_mask), np.asarray(out_j.h_mask))
    assert 0.3 < _np(out_t.h_mask).mean() < 1.0
    scale = float(np.abs(np.asarray(out_j.embed)).max())
    np.testing.assert_allclose(_np(out_t.embed), np.asarray(out_j.embed),
                               rtol=0, atol=2e-2 * scale)
    np.testing.assert_allclose(_np(out_t.normal_coarse),
                               np.asarray(out_j.normal_coarse), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(_np(out_t.normal_fine),
                               np.asarray(out_j.normal_fine), rtol=0,
                               atol=1e-2)


def test_sigma_gradient_through_the_exact_projection(field_setup):
    """The training forward without frames: the -grad(sigma) target goes
    through diff_project (tangential + normal) and matches JAX's."""
    s = field_setup
    cj, ct = s["cj"], s["ct"]
    x = _surface_points(s["mp"], 800, 0.08, 10)
    rng = np.random.default_rng(10)
    v = rng.normal(size=x.shape)
    v = (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)
    key = jax.random.PRNGKey(12)
    _, _, ex_j = jcf.forward(s["pj"], s["tj"].field_state, jnp.asarray(x),
                             jnp.asarray(v), cj, key=key, training=True)
    noise = _t(jax.random.normal(key, (len(x), cj.field.encoder_f_out_dim)))
    _, _, ex_t = tcf.forward(s["pt"], s["st"], _t(x), _t(v), ct,
                             noise=noise, training=True)
    g_t, g_j = _np(ex_t["normal_grad"]), np.asarray(ex_j["normal_grad"])
    fin = np.isfinite(g_j).all(-1)
    np.testing.assert_array_equal(np.isfinite(g_t).all(-1), fin)
    cos = np.sum(g_t * g_j, -1) / (np.linalg.norm(g_t, axis=-1)
                                   * np.linalg.norm(g_j, axis=-1) + 1e-12)
    assert np.mean(cos[fin] >= 1 - 1e-4) >= 0.99, np.sort(cos[fin])[:10]


def test_refresh_without_the_anchor_table_matches_jax(field_setup):
    s = field_setup
    tj, cj, rj, ct, rt = s["tj"], s["cj"], s["rj"], s["ct"], s["rt"]
    tj.state = tj.state._replace(params=s["pj"])
    near = jct.compute_near_cells(np.asarray(tj.field_state.projector
                                             .vertices), rj.grid_size,
                                  rj.bound, cj.field.h_threshold)
    # the exact chain refreshes in chunks of 65,536 cells, one key each
    assert len(near) < 65536
    key = jax.random.PRNGKey(13)
    _, k = jax.random.split(key)
    half = 1.0 / rj.grid_size
    noise = np.array(jax.random.uniform(k, (65536, 3), minval=-half,
                                        maxval=half))[:len(near)]
    st_j = jct.curved_grid_step(
        tj.state._replace(occ=jocc.create(rj.grid_size, 1)), tj.field_state,
        key, ccfg=cj, rcfg=rj, near_cells=near, anchor_tab=None,
        rt=tj.runtime)
    st_t = tct.init_curved_state(torch.Generator(), ct, rt,
                                 tct.CurvedTrainConfig(), params=s["pt"])
    st_t = tct.curved_grid_step(
        dataclasses.replace(st_t, params=tct.curved_infer_params(
            st_t.params, ct)), s["st"], [torch.from_numpy(noise)], ccfg=ct,
        rcfg=rt, near_cells=near, anchor_tab=None,
        rt=tmf.FieldRuntime.default())
    np.testing.assert_array_equal(_np(st_t.occ.occ), np.asarray(st_j.occ.occ))
    assert 0 < _np(st_t.occ.occ).sum() < rt.grid_size ** 3
    d_t, d_j = _np(st_t.occ.density), np.asarray(st_j.occ.density)
    close = np.abs(d_t - d_j) <= 1e-5 * np.maximum(np.abs(d_j), 1.0)
    assert close.mean() >= 0.99
    # the port's own refresh of the same trainer state reaches these
    # cells too (per_ray_projection off: no anchor table)
    fcfg = dataclasses.replace(ct.field, per_ray_projection=False)
    tt = tct.CurvedTrainer(_DS, s["st"],
                           dataclasses.replace(ct, field=fcfg), rt,
                           tct.CurvedTrainConfig(), device="cpu")
    assert tt._refresh_anchor_tab() is None
    assert np.array_equal(_np(tt._get_near_cells()), near)
    tt.initialize_states(1)
    assert int(tt.state.occ.iter_density) == 1


class _DS:
    """The dataset fields ``CurvedTrainer`` reads, for a refresh only."""

    poses = np.eye(4, dtype=np.float32)[None]
    images = np.zeros((1, 4, 4, 4), np.uint8)
    intrinsics = np.array([4.0, 4.0, 2.0, 2.0], np.float32)
    H = W = 4
    num_frames = 1
