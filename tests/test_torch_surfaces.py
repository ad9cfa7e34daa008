"""Surfaces in the PyTorch port vs the JAX package: the mesh tools
(``geometry/shape_tools.py``), the isosurface export
(``ops/isosurface.py``, ``field_io.save_mesh``) and the texture synthesis
on a curved surface (``synthesis/curved.py`` and its CLI).

Small sizes: ``make_icosphere``, ``make_box`` and ``make_plane`` of the
JAX package; the synthesis at ``tests/test_curved_synthesis.py``'s size
(``make_icosphere(2, 0.6)``, a 48^2 UV map, 6 patches of 12^2 x 4,
``grid_gap`` 0.05, the plain matcher, ``max_iters`` 400); an NGP of
``tests/test_torch_ngp.py``'s width for the density grid.

Tolerances, each with its reason:
- the triangle grid's cell lists: equal to the per-face loop's;
- the host mirrors (shape tools, ``surface_nets``, ``augment_patches``,
  ``define_vector_field``, ``pca_color_transform``, ``SparseProxyDist``,
  ``_interp_on_grid``): bit for bit -- the same numpy statements on the
  same input (the port's range votes are int8, the JAX class's float64:
  compared as numbers);
- ``register_template`` on the JAX package's draws: vertices within 1e-5
  (optax and torch's Adam sum in other orders, and Adam's step divides
  by the root of the second moment, which amplifies a last-bit
  difference of a small gradient; measured 8.9e-7 after 25 steps);
- ``resize_bilinear`` (``grid_sample_2d``): 1e-6, and the matcher picks
  the same patch;
- the density grid of an NGP: within 1e-5 (relative, floor 1e-6) on
  >= 99% of the corners (the NGP bound of tests/test_torch_ngp.py: a
  bf16 MLP input can round to a neighbouring value after a last-bit
  difference); the faces are
  equal wherever no corner moved across the threshold, and the vertices
  within 1e-5 on >= 99% of them and 1e-4 on all (a crossing's place
  divides the value error by the value step along its edge; measured
  2.9e-5 at 41 of 97,044 coordinates);
- ``uv2vert`` and ``extract_patch_on_surface``: the same hits and masks,
  positions and uvs within 1e-6 (the queries' bounds of
  ``tests/test_torch_projection.py``);
- the whole synthesis loop: the same seed sequence and set texels, and
  every value within 1e-5 but at the queries where the patch grid's
  3rd and 4th nearest texels tie within 1e-6 (the loop's
  inverse-distance blend then takes either; measured: 2 of 1,567 texels,
  ties within 1.5e-9).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from nerf_texture_tpu.geometry import mesh as jmesh
from nerf_texture_tpu.geometry import projector as jproj
from nerf_texture_tpu.geometry import shape_tools as jst
from nerf_texture_tpu.models import ngp as jngp
from nerf_texture_tpu.ops import isosurface as jiso
from nerf_texture_tpu.synthesis import curved as jc
from nerf_texture_tpu.train import field_io as jio
from nerf_texture_tpu_torch.convert import params_from_jax
from nerf_texture_tpu_torch.geometry import mesh as tmesh
from nerf_texture_tpu_torch.geometry import projector as tproj
from nerf_texture_tpu_torch.geometry import shape_tools as tst
from nerf_texture_tpu_torch.geometry import spatial as tspatial
from nerf_texture_tpu_torch.models import ngp as tngp
from nerf_texture_tpu_torch.ops import isosurface as tiso
from nerf_texture_tpu_torch.synthesis import curved as tc
from nerf_texture_tpu_torch.train import field_io as tio

MESHES = {
    "icosphere": lambda m: m.make_icosphere(2, radius=0.6),
    "box": lambda m: m.make_box((0.5, 0.35, 0.25)),
    "plane": lambda m: m.make_plane(6, 0.7),
}
NGP_KW = dict(bound=1.0, num_levels=4, level_dim=4, log2_bricks=10,
              desired_resolution=256, hidden_dim=32, hidden_dim_color=32,
              train_table_bf16=False)
SYN = dict(grid_gap=0.05, resolution=48, use_matchlib=False, max_iters=400)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The ray cast and the kNN run many small tensor ops: beside
    pytest-xdist's other workers, a full intra-op thread pool makes each
    of them wait on the busy cores.  Two threads a worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _same_mesh(a, b):
    np.testing.assert_array_equal(a.vertices, b.vertices)
    np.testing.assert_array_equal(a.faces, b.faces)
    assert (a.uvs is None) == (b.uvs is None)
    if a.uvs is not None:
        np.testing.assert_array_equal(a.uvs, b.uvs)


# ---------------------------------------------------------------------------
# shape tools
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(MESHES))
def test_shape_tools_match_bit_for_bit(name):
    mt, mj = MESHES[name](tmesh), MESHES[name](jmesh)
    for ft, fj in (
            (tst.subdivide, jst.subdivide),
            (lambda m: tst.subdivide_to(m, 700),
             lambda m: jst.subdivide_to(m, 700)),
            (lambda m: tst.laplacian_smooth(m, 5, 0.4),
             lambda m: jst.laplacian_smooth(m, 5, 0.4)),
            (tst.keep_largest_component, jst.keep_largest_component),
            (tst.remesh_isotropic, jst.remesh_isotropic),
            (lambda m: tst.remesh_isotropic(m, 0.5 * m.mean_edge_length),
             lambda m: jst.remesh_isotropic(m, 0.5 * m.mean_edge_length)),
            (lambda m: tst.normalize_mesh(m, 1.2),
             lambda m: jst.normalize_mesh(m, 1.2)),
            (lambda m: tst.align_bbox(m, tmesh.make_icosphere(0, 3.0)),
             lambda m: jst.align_bbox(m, jmesh.make_icosphere(0, 3.0))),
            (lambda m: tst.arap_deform(m, [0, 3], m.vertices[[0, 3]] + 0.05),
             lambda m: jst.arap_deform(m, [0, 3],
                                       m.vertices[[0, 3]] + 0.05))):
        _same_mesh(ft(mt), fj(mj))
    # the midpoint ids follow the faces' first visit of each edge
    sub = tst.subdivide(mt)
    a, b = mt.faces[0, :2]
    np.testing.assert_array_equal(sub.vertices[len(mt.vertices)],
                                  (mt.vertices[a] + mt.vertices[b]) / 2)


def _loop_triangle_cells(vertices, faces, res, max_per_cell):
    """The triangle grid's cell lists as a loop over the faces and their
    AABB cells (the reference of ``spatial.build_triangle_grid``'s sort):
    each cell lists its first ``max_per_cell`` faces by id.  Cells in
    float32, as the JAX package's native builder
    (``native/spatial_build.cpp``) finds them: a vertex on a cell face,
    as the plane's are, can fall on the other side in float64."""
    tris = np.asarray(vertices, np.float64)[np.asarray(faces)]
    lo = tris.reshape(-1, 3).min(0) - 1e-3
    hi = tris.reshape(-1, 3).max(0) + 1e-3
    cell_size = float((hi - lo).max() / res)
    t32 = tris.astype(np.float32)
    lo32, cs32 = lo.astype(np.float32), np.float32(cell_size)
    tmin = np.clip(((t32.min(1) - lo32) / cs32).astype(np.int64), 0,
                   res - 1)
    tmax = np.clip(((t32.max(1) - lo32) / cs32).astype(np.int64), 0,
                   res - 1)
    lists: dict = {}
    for fi in range(len(tris)):
        for x in range(tmin[fi, 0], tmax[fi, 0] + 1):
            for y in range(tmin[fi, 1], tmax[fi, 1] + 1):
                for z in range(tmin[fi, 2], tmax[fi, 2] + 1):
                    lists.setdefault((x * res + y) * res + z, []).append(fi)
    out = -np.ones((res ** 3, max_per_cell), np.int32)
    for c, items in lists.items():
        out[c, :min(len(items), max_per_cell)] = items[:max_per_cell]
    return out


@pytest.mark.parametrize("name", list(MESHES))
def test_triangle_grid_matches_the_loop_binning(name):
    m = tst.subdivide(MESHES[name](tmesh))
    for res, per_cell in ((8, 24), (13, 4)):
        got = tspatial.build_triangle_grid(m.vertices, m.faces, res,
                                           per_cell, device="cpu")
        np.testing.assert_array_equal(
            got.cell_items.numpy(),
            _loop_triangle_cells(m.vertices, m.faces, res, per_cell))


def test_point_tools_match_bit_for_bit():
    rng = np.random.default_rng(1)
    pts = rng.normal(size=(200, 3))
    shifted = pts @ np.linalg.qr(rng.normal(size=(3, 3)))[0][:3, :3] * 0.1 \
        + pts * 0.9 + [0.05, -0.03, 0.02]
    for a, b in zip(tst.icp(shifted, pts, 20, 1.0),
                    jst.icp(shifted, pts, 20, 1.0)):
        np.testing.assert_array_equal(a, b)
    assert tst.chamfer_distance(shifted, pts) == \
        jst.chamfer_distance(shifted, pts)
    flat = rng.normal(size=(100, 3)) * [3, 2, 0.01]
    for a, b in zip(tst.pca_plane(flat), jst.pca_plane(flat)):
        np.testing.assert_array_equal(a, b)


def test_external_tools_pass_through_without_binaries(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    path = str(tmp_path / "m.obj")
    assert tst.coacd(path) == jst.coacd(path) == path
    assert tst.manifold_union(path, str(tmp_path)) == \
        jst.manifold_union(path, str(tmp_path)) == path


def _jax_registration_draws(seed, iterations, n_samples, n_faces):
    """The surface draws of the JAX loop: per iteration the key split
    from the running key, then (k1, k2, k3); the face pick is
    ``jax.random.categorical`` on log(areas + 1e-12), i.e. the argmax of
    Gumbel noise from k1 plus the logits."""
    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(iterations):
        key, k = jax.random.split(key)
        k1, k2, k3 = jax.random.split(k, 3)
        out.append((np.asarray(jax.random.gumbel(k1, (n_samples, n_faces))),
                    np.asarray(jax.random.uniform(k2, (n_samples, 1))),
                    np.asarray(jax.random.uniform(k3, (n_samples, 1)))))
    return out


def test_register_template_on_jax_draws():
    src_t, src_j = tmesh.make_icosphere(1, 0.5), jmesh.make_icosphere(1, 0.5)
    trg = jmesh.make_box((0.45, 0.3, 0.35))
    trg_pts = jst.subdivide(jst.subdivide(trg)).vertices
    kw = dict(iterations=25, lr=0.02, n_samples=300, seed=3)
    g = _jax_registration_draws(3, kw["iterations"], kw["n_samples"],
                                len(src_t.faces))

    def draws(i, areas):
        logits = np.log(areas.numpy() + np.float32(1e-12))
        fid = np.argmax(g[i][0] + logits[None], axis=-1)
        return (torch.from_numpy(fid), torch.tensor(g[i][1]),
                torch.tensor(g[i][2]))

    got = tst.register_template(src_t, trg_pts, draws=draws, device="cpu",
                                **kw)
    want = jst.register_template(src_j, trg_pts, **kw)
    np.testing.assert_array_equal(got.faces, want.faces)
    moved = np.abs(want.vertices - src_j.vertices).max()
    assert moved > 0.05
    err = np.abs(got.vertices - want.vertices).max()
    assert err <= 1e-5, err
    # the default draws (torch.Generator) run too and move the mesh
    own = tst.register_template(src_t, trg_pts, device="cpu", **kw)
    assert tst.chamfer_distance(own.vertices, trg_pts) < \
        tst.chamfer_distance(src_t.vertices, trg_pts)


# ---------------------------------------------------------------------------
# isosurface
# ---------------------------------------------------------------------------

def _blob(p, lib):
    r = lib.sqrt(lib.sum(p * p, -1))
    return 40.0 * lib.exp(-4.0 * (r - 0.1 * lib.sin(7 * p[..., 0])) ** 2)


def test_surface_nets_bit_for_bit():
    rng = np.random.default_rng(0)
    vals = _blob(np.stack(np.meshgrid(*[np.linspace(-1, 1, 24)] * 3,
                                      indexing="ij"), -1), np) \
        + rng.normal(scale=0.5, size=(24, 24, 24))
    for thr in (10.0, 25.0, 1e3):
        vt, ft = tiso.surface_nets(vals, thr, 1.0)
        vj, fj = jiso.surface_nets(vals, thr, 1.0)
        np.testing.assert_array_equal(vt, vj)
        np.testing.assert_array_equal(ft, fj)
    assert len(ft) == 0 and len(tiso.surface_nets(vals, 10.0, 1.0)[1]) > 100


def test_density_grid_and_save_mesh_match(tmp_path):
    p = jax.tree.map(np.asarray, jngp.init(jax.random.PRNGKey(0),
                                           jngp.NGPConfig(**NGP_KW)))
    p["grid"] = p["grid"] * 1e4
    pj, pt = jax.tree.map(jnp.asarray, p), params_from_jax(p, device="cpu")
    jcfg, tcfg = jngp.NGPConfig(**NGP_KW), tngp.NGPConfig(**NGP_KW)
    R, chunk = 33, 5000                     # several chunks, a ragged tail

    def fn_t(x):
        return tngp.density(pt, x, tcfg)[0]

    def fn_j(x):
        return jngp.density(pj, x, jcfg)[0]

    g_t = tiso.sample_density_grid(fn_t, R, 1.0, chunk=chunk, device="cpu")
    g_j = jiso.sample_density_grid(fn_j, R, 1.0, chunk=chunk)
    assert g_t.shape == g_j.shape == (R, R, R) and g_t.dtype == np.float32
    close = np.abs(g_t - g_j) <= 1e-5 * np.abs(g_j) + 1e-6
    assert close.mean() >= 0.99, close.mean()
    thr = float(np.median(g_j))
    v_t, f_t = tio.save_mesh(fn_t, str(tmp_path / "t.obj"), resolution=R,
                             threshold=thr, device="cpu")
    v_j, f_j = jio.save_mesh(fn_j, str(tmp_path / "j.obj"), resolution=R,
                             threshold=thr)
    assert len(f_j) > 100
    if np.array_equal(g_t > thr, g_j > thr):
        np.testing.assert_array_equal(f_t, f_j)
        # a crossing's place divides the value error by the edge's value
        # step: within 1e-5 on >= 99% of the vertices, 1e-4 on all
        err = np.abs(v_t - v_j).max(-1)
        assert (err <= 1e-5).mean() >= 0.99 and err.max() <= 1e-4, err.max()
    else:                # a corner crossed the threshold: it lay within 1e-5
        flip = (g_t > thr) != (g_j > thr)
        assert np.all(np.abs(g_j[flip] - thr) <= 1e-5 * abs(thr) + 1e-6)
    lt, lj = tmesh.load_obj(str(tmp_path / "t.obj")), jmesh.load_obj(
        str(tmp_path / "j.obj"))
    assert len(lt.faces) == len(f_t) and len(lj.faces) == len(f_j)
    # an analytic density: the same grid bit for bit, so the same mesh
    b_t = tiso.sample_density_grid(lambda x: _blob(x, torch), R, 1.0,
                                   chunk=chunk, device="cpu")
    b_j = jiso.sample_density_grid(lambda x: _blob(x, jnp), R, 1.0,
                                   chunk=chunk)
    np.testing.assert_allclose(b_t, b_j, rtol=1e-6, atol=1e-6)
    m_t = tiso.extract_mesh(lambda x: _blob(x, torch), resolution=R,
                            device="cpu")
    assert len(m_t[1]) > 100
    r = np.linalg.norm(m_t[0], axis=-1)
    assert 0.3 < r.mean() < 1.0


# ---------------------------------------------------------------------------
# synthesis components
# ---------------------------------------------------------------------------

def test_synthesis_host_helpers_match_bit_for_bit():
    rng = np.random.default_rng(0)
    patches = rng.normal(size=(4, 20, 20, 3)).astype(np.float32)
    for kw in (dict(), dict(crop_factor=3), dict(mirror_vert=False),
               dict(crop_shift=False, mirror_hor=False)):
        np.testing.assert_array_equal(tc.augment_patches(patches, **kw),
                                      jc.augment_patches(patches, **kw))
    for name in MESHES:
        mt, mj = MESHES[name](tmesh), MESHES[name](jmesh)
        np.testing.assert_array_equal(tc.define_vector_field(mt),
                                      jc.define_vector_field(mj))
    data = rng.normal(size=(50, 7))
    a, b = tc.pca_color_transform(data, 3), jc.pca_color_transform(data, 3)
    x = rng.normal(size=(5, 4, 7))
    np.testing.assert_array_equal(a(x), b(x))
    p_verts = rng.normal(size=(6, 6, 3))
    vals = rng.normal(size=(6, 6, 4)).astype(np.float32)
    q = rng.normal(size=(30, 3))
    np.testing.assert_array_equal(tc._interp_on_grid(p_verts, vals, q),
                                  jc._interp_on_grid(p_verts, vals, q))


def test_sparse_proxy_dist_matches():
    rng = np.random.default_rng(2)
    dense = rng.uniform(size=(500, 3))
    for sparse, gap in ((None, 0.3), (dense[::7], 0.25)):
        a = tc.SparseProxyDist(dense, sparse, preferred_patch_gap=gap)
        b = jc.SparseProxyDist(dense, sparse, preferred_patch_gap=gap)
        np.testing.assert_array_equal(a.sparse, b.sparse)
        np.testing.assert_array_equal(a.d2s, b.d2s)
        assert a.sparse_avg == b.sparse_avg
        a.set_range_vote(gap)
        b.set_range_vote(gap)
        assert a.votes.dtype == np.int8
        np.testing.assert_array_equal(a.votes.astype(float), b.dist)
        done = np.zeros(500, bool)
        done[:10] = True
        hist = [0]
        for _ in range(20):
            s = a.range_vote(hist, done)
            assert s == b.range_vote(hist, done)
            hist.append(s)
            done[s] = True
        np.testing.assert_array_equal(
            a.pick_vertices_to_set(dense[:5], 0.05),
            b.pick_vertices_to_set(dense[:5], 0.05))
    with pytest.raises(ValueError, match="set_range_vote"):
        tc.SparseProxyDist(dense, preferred_patch_gap=0.3).range_vote(
            [0], done)


def test_matching_lib_matches():
    rng = np.random.default_rng(0)
    base = rng.normal(size=(4, 20, 20, 3))
    patches = tc.augment_patches(np.cumsum(base, 1).astype(np.float32))
    img = patches[5]
    np.testing.assert_allclose(tc.resize_bilinear(img, 7, 9, device="cpu"),
                               jc.resize_bilinear(img, 7, 9), rtol=0,
                               atol=1e-6)
    batch = tc.resize_bilinear(patches[:6], 5, 5, device="cpu")
    for i in range(6):
        np.testing.assert_array_equal(
            batch[i], tc.resize_bilinear(patches[i], 5, 5, device="cpu"))
    for kw in (dict(), dict(channel_pca_dim=2), dict(pyramid_height=3,
                                                     pyramid_size_factor=3)):
        lt = tc.MatchingLib(patches, device="cpu", **kw)
        lj = jc.MatchingLib(patches, **kw)
        assert lt.sizes == lj.sizes and lt.keep_nums == lj.keep_nums
        for a, b in zip(lt.levels, lj.levels):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
        for i in (7, 30):
            cond = patches[i] + rng.normal(scale=0.3, size=patches[i].shape
                                           ).astype(np.float32)
            mask = (rng.uniform(size=(*cond.shape[:2], 1)) > 0.3).astype(
                np.float32)
            assert lt.match(cond, mask) == lj.match(cond, mask)


@pytest.fixture(scope="module")
def sphere():
    """(port projector, JAX projector) of make_icosphere(2, 0.6), and the
    uv2vert of each at 48^2."""
    mp = tproj.MeshProjector(tmesh.make_icosphere(2, 0.6), device="cpu")
    mpj = jproj.MeshProjector(jmesh.make_icosphere(2, 0.6))
    return dict(mp=mp, mpj=mpj, t=tc.uv2vert(mp, resolution=48),
                j=jc.uv2vert(mpj, resolution=48))


def test_uv2vert_and_extract_patch_match(sphere):
    (v_t, i_t, r_t), (v_j, i_j, r_j) = sphere["t"], sphere["j"]
    assert r_t == r_j == 48 and len(v_j) > 100
    np.testing.assert_array_equal(i_t, i_j)
    np.testing.assert_allclose(v_t, v_j, rtol=0, atol=1e-6)
    vec = jc.define_vector_field(sphere["mpj"].mesh)
    stats = {}
    for k in range(0, len(v_j), len(v_j) // 6):
        for gap in (0.01, 0.05):
            a = tc.extract_patch_on_surface(sphere["mp"], v_j[k], 12, vec,
                                            gap, stats=stats)
            b = jc.extract_patch_on_surface(sphere["mpj"], v_j[k], 12, vec,
                                            gap)
            np.testing.assert_array_equal(a[2], b[2])
            np.testing.assert_array_equal(a[3], b[3])
            assert a[2].any()
            for x, y in zip(a[:2], b[:2]):
                np.testing.assert_allclose(x[a[2]], y[b[2]], rtol=0,
                                           atol=1e-6)
    assert stats["device_s"] > 0


def test_curved_synthesis_loop_matches(sphere, monkeypatch):
    """The whole loop on the same texels: the same seeds, the same set
    texels, values within 1e-5 but where the blend's kNN ties."""
    v, ids, res = sphere["j"]
    vec = jc.define_vector_field(sphere["mpj"].mesh)
    patches = np.random.default_rng(3).normal(size=(6, 12, 12, 4)).astype(
        np.float32)
    logs = {}
    for name, mod in (("t", tc), ("j", jc)):
        log = logs[name] = {"seed": [], "interp": []}
        orig_vote, orig_interp = mod.SparseProxyDist.range_vote, \
            mod._interp_on_grid

        def vote(self, h, d, orig=orig_vote, log=log):
            log["seed"].append(orig(self, h, d))
            return log["seed"][-1]

        def interp(*a, orig=orig_interp, log=log):
            log["interp"].append((a, orig(*a)))
            return log["interp"][-1][1]

        monkeypatch.setattr(mod.SparseProxyDist, "range_vote", vote)
        monkeypatch.setattr(mod, "_interp_on_grid", interp)
    stats = {}
    out_t = tc.synthesis_on_uvmap(sphere["mp"], v, ids, res, patches, vec,
                                  0.01, tc.CurvedSynthesisConfig(**SYN),
                                  stats=stats)
    out_j = jc.synthesis_on_uvmap(sphere["mpj"], v, ids, res, patches, vec,
                                  0.01, jc.CurvedSynthesisConfig(**SYN))
    assert logs["t"]["seed"] == logs["j"]["seed"]
    assert stats["iters"] == len(logs["t"]["seed"]) and stats["done"] == 1.0
    ties = 0
    for (at, rt), (aj, rj) in zip(logs["t"]["interp"], logs["j"]["interp"]):
        np.testing.assert_allclose(at[0], aj[0], rtol=0, atol=1e-6)
        np.testing.assert_allclose(at[2], aj[2], rtol=0, atol=0)
        off = np.abs(rt - rj).max(-1) > 1e-5
        if off.any():
            d, _ = cKDTree(aj[0].reshape(-1, 3)).query(aj[2][off], k=4)
            assert np.all(d[:, 3] - d[:, 2] <= 1e-6), d
            ties += int(off.sum())
    f_t, f_j = out_t["features"], out_j["features"]
    set_t, set_j = np.abs(f_t).sum(1) > 0, np.abs(f_j).sum(1) > 0
    np.testing.assert_array_equal(set_t, set_j)
    assert set_j.mean() > 0.2
    assert (np.abs(f_t - f_j).max(1) > 1e-5).sum() <= ties \
        <= 0.01 * set_j.sum()
    for k in out_j:
        if out_j[k] is None:
            assert out_t[k] is None
        else:
            assert np.asarray(out_t[k]).dtype == np.asarray(out_j[k]).dtype
            if k != "features":
                np.testing.assert_array_equal(out_t[k], out_j[k], err_msg=k)


def test_cli_writes_curved_mesh_npz(tmp_path, sphere):
    """The port's CLI on the CPU at a small size: its curved_mesh.npz has
    the JAX CLI's keys and loads as a canvas in the JAX package."""
    import texture_synthesis_on_curved_surface_torch as cli

    rng = np.random.default_rng(4)
    field = tmp_path / "field.npz"
    np.savez(field, patches=rng.normal(size=(3, 10, 10, 4)).astype(
        np.float32), grid_gap=np.float64(0.02))
    target = tmp_path / "target.obj"
    tmesh.save_obj(str(target), tmesh.make_box((0.5, 0.35, 0.25)))
    out = tmp_path / "curved_mesh.npz"
    cli.main([str(field), str(target), "--grid_gap", "0.06", "--resolution",
              "24", "--out", str(out), "--device", "cpu"])
    d = np.load(out, allow_pickle=True)
    assert sorted(d.files) == sorted(["features", "mesh_vertices",
                                      "mesh_faces", "uv", "sdf_factor",
                                      "original_grid_gap"])
    assert d["features"].shape == (1, 4, 24, 24)
    assert abs(float(d["sdf_factor"]) - 3.0) < 1e-9
    assert np.abs(d["mesh_vertices"]).max() <= 1 / 1.5 + 1e-9
    assert (np.abs(d["features"]).sum(1) > 0).mean() > 0.05
