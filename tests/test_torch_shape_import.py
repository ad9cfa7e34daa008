"""The imports onto another mesh and the exports of the PyTorch port vs
the JAX package: mesh_field modes 'shape' and 'unhash', the loaders
``load_shape`` / ``load_unhash`` / ``unhash`` with their grid refreshes
and frames, ``_bake_vertex_features``, ``save_point_cloud``,
``take_photo`` / ``render_round``, and curved_mesh.npz files across the
packages.

Small width: the configs of ``tests/test_torch_texture.py`` (3 levels x
2 channels, grid 16, ``make_icosphere(2, 0.5)``, 8x8 patches, a 32x32
canvas, 32x32 frames), seeded and scaled JAX params converted, not
trained.  The target mesh is a rounded box (``make_box((0.5, 0.35,
0.25))`` subdivided to 386 vertices, smoothed); the curved_mesh.npz
files are each package's synthesis of the field npz's patches onto it
(a 24^2 UV map; the port's 12 iterations, which both packages import,
and the JAX package's set-up alone, whose file the port imports).  The
JAX loaders run with one grid refresh in place of their 50 (each takes
seconds on the CPU), and the JAX functions on the port's grid tables
(the JAX package bins its cells in f32 C++; see
``tests/test_torch_projection.py``); the port's loaders with their 50
refreshes in mode 'shape' of ``load_unhash`` and with one in the others.

Tolerances, each with its reason:
- ``mesh_field.apply``: the field bounds of
  ``tests/test_torch_curved_field.py`` -- features within 2e-2 of
  their largest entry (bf16 table rows), fine normals 1e-2, coarse
  normals 1e-5 and masks exact;
- the grid refresh of each mode with JAX's jitter: masks exact,
  densities within 1e-5 (relative) on >= 99% of the cells;
- frames on JAX's grid: the frame bounds of
  ``tests/test_torch_curved_render.py``, PSNR >= 45 dB, max abs
  <= 5e-2, live pixels differing <= 0.5%;
- ``_bake_vertex_features``: 1e-5 (the nearest-face barycentrics agree
  within 1e-6);
- ``save_point_cloud`` on the same views: the same count, points within
  1e-4 on >= 95% of them and within 5e-2 on all (the slice's depth
  bound in tests/test_torch_render.py: the composited depth follows the
  sample weights, which agree within the frames' bounds; measured 3.2%
  above 1e-4, at most 8.0e-4);
- the PNG files: read back (imageio) equal to the array written, which
  is the 8-bit image the JAX package would write for that frame.
"""

import dataclasses

import imageio.v3 as iio
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax_draws import curved_grid_noise
from nerf_texture_tpu.data.synthetic import SyntheticSphereDataset
from nerf_texture_tpu.geometry import mesh as jmesh
from nerf_texture_tpu.geometry import shape_tools as jst
from nerf_texture_tpu.geometry import spatial as jspatial
from nerf_texture_tpu.geometry.projector import (
    MeshProjector as JaxMeshProjector)
from nerf_texture_tpu.models import curved_field as jcf
from nerf_texture_tpu.models import mesh_field as jmf
from nerf_texture_tpu.ops import occupancy as jocc
from nerf_texture_tpu.render import renderer as jr
from nerf_texture_tpu.synthesis import curved as jc
from nerf_texture_tpu.synthesis import patches as jpatches
from nerf_texture_tpu.synthesis import quilting as jquilt
from nerf_texture_tpu.train import curved_trainer as jct
from nerf_texture_tpu.train import field_io as jio
from nerf_texture_tpu_torch.convert import occupancy_from_jax, params_from_jax
from nerf_texture_tpu_torch.data import synthetic as tsyn
from nerf_texture_tpu_torch.data.poses import orbit_pose
from nerf_texture_tpu_torch.geometry import mesh as tmesh
from nerf_texture_tpu_torch.geometry import shape_tools as tst
from nerf_texture_tpu_torch.geometry.projector import MeshProjector
from nerf_texture_tpu_torch.models import curved_field as tcf
from nerf_texture_tpu_torch.models import mesh_field as tmf
from nerf_texture_tpu_torch.render.renderer import RenderConfig
from nerf_texture_tpu_torch.synthesis import curved as tc
from nerf_texture_tpu_torch.train import curved_trainer as tct
from nerf_texture_tpu_torch.train import field_io as tio

FIELD = dict(num_levels=3, level_dim=2, base_resolution=16,
             desired_resolution=32, log2_bricks=9, h_threshold=0.12,
             clustering=False)
MODEL = dict(light_model="SH", hidden_dim=16, geo_feat_dim=7)
RENDER = dict(bound=1.0, cascades=1, grid_size=16, max_steps=48,
              max_samples_train=24, max_samples_infer=32, ray_chunk=256,
              pool_mean_samples=16, pool_mean_samples_infer=16,
              proxy_samples=0)
SCFG = dict(patch_size=8, max_patch_num=6, center_batch=3, pattern_rate=1 / 4)
HW = 32
POSES = [orbit_pose(1.1, 0.6, 2.0), orbit_pose(2.0, 3.5, 2.0)]
MODES = ["load_shape", "load_unhash", "unhash"]
UNHASH_VERTICES = 600          # make_icosphere(2) subdivided once: 642


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The ray cast and the kNN run many small tensor ops: two threads a
    pytest-xdist worker (a full pool waits on the other workers' cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np(a):
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _jax_grid(g):
    return jspatial.GridIndex(
        cell_items=jnp.asarray(_np(g.cell_items), jnp.int32),
        fallback=jnp.asarray(_np(g.fallback), jnp.int32),
        origin=jnp.asarray(_np(g.origin)),
        cell_size=jnp.asarray(_np(g.cell_size)), res=g.res)


def _on_port_grids(arrays_j, arrays_t):
    """A JAX ProjectorArrays on the port's vertex and triangle grids."""
    return arrays_j._replace(vgrid=_jax_grid(arrays_t.vgrid),
                             tgrid=_jax_grid(arrays_t.tgrid))


def _target(mod_mesh, mod_tools):
    return mod_tools.laplacian_smooth(mod_tools.subdivide_to(
        mod_mesh.make_box((0.5, 0.35, 0.25)), 300), 4)


def _quilt(field_path, tex_path):
    data = np.load(field_path, allow_pickle=True)
    patches = np.concatenate(
        [data["patches"], data["patch_phi_embed"],
         data["patch_local_tbn"].reshape(*data["patch_local_tbn"].shape[:3],
                                         9)], -1)
    syn = jquilt.QuiltingSynthesizer(
        patches, jquilt.QuiltingConfig(output_size=(32, 32), seed=0),
        match_dim=data["patches"].shape[-1],
        sample_tbn=data["patch_sample_tbn"],
        picked_vertices=data["picked_vertices"],
        patch_length=float(data["grid_gap"]) * 8)
    syn.synthesize()
    tex = syn.export(grid_gap=float(data["grid_gap"]),
                     phi_embed_dim=data["patch_phi_embed"].shape[-1])
    np.savez(tex_path, **{k: v for k, v in tex.items() if v is not None})


def _synthesise(mod, mp, field_path, out_path, texels, iters):
    """One package's curved_mesh.npz: the field npz's patches onto the
    normalised target's 24^2 UV map (``texels``: the port's uv2vert of
    it, which tests/test_torch_surfaces.py holds to the JAX package's),
    ``iters`` iterations."""
    data = np.load(field_path, allow_pickle=True)
    verts, ids, res = texels
    cfg = mod.CurvedSynthesisConfig(grid_gap=0.1, resolution=24,
                                    use_matchlib=False, max_iters=iters)
    out = mod.synthesis_on_uvmap(mp, verts, ids, res, data["patches"],
                                 mod.define_vector_field(mp.mesh),
                                 original_grid_gap=float(data["grid_gap"]),
                                 cfg=cfg)
    np.savez(out_path, **{k: v for k, v in out.items() if v is not None})


@pytest.fixture(scope="module")
def pipeline(tmp_path_factory):
    """JAX and port CurvedTrainers on the same seeded params and grid, the
    JAX package's field and texture npz, both packages' curved_mesh.npz
    on the target, and each import mode's state of both trainers."""
    d = tmp_path_factory.mktemp("shape")
    cj = jcf.CurvedFieldConfig(field=jmf.MeshFieldConfig(**FIELD), **MODEL)
    ct = tcf.CurvedFieldConfig(field=tmf.MeshFieldConfig(**FIELD), **MODEL)
    rj = jr.RenderConfig(**RENDER)
    rt = RenderConfig(**dataclasses.asdict(rj))
    mesh_j = jmesh.make_icosphere(2, radius=0.5)
    mesh_t = tmesh.make_icosphere(2, radius=0.5)
    pt_base = MeshProjector(mesh_t, device="cpu")
    base_j = _on_port_grids(JaxMeshProjector(mesh_j).arrays, pt_base.arrays)
    tj = jct.CurvedTrainer(SyntheticSphereDataset(n_frames=2, H=HW, W=HW),
                           jmf.make_state(_Arrays(base_j)), cj, rj,
                           jct.CurvedTrainConfig(), key=jax.random.PRNGKey(0))
    p = jax.tree.map(np.array, tj.state.params)
    rw = cj.field.feature_spec.row_width
    p["field"]["encoder"][:, :rw] *= 1e4
    p["field"]["normal"]["phi_grid"] *= 1e3
    pj = jax.tree.map(jnp.asarray, p)
    tj.state = tj.state._replace(params=pj, ema_params=pj)
    tj.initialize_states(1)
    tt = tct.CurvedTrainer(tsyn.SyntheticSphereDataset(n_frames=2, H=HW,
                                                       W=HW),
                           tmf.make_state(pt_base), ct, rt,
                           tct.CurvedTrainConfig(), device="cpu")
    tt.state.params = params_from_jax(p, device="cpu")
    tt.state.ema_params = tt.state.params
    field_j = str(d / "field_jax.npz")
    jio.save_field(tj, field_j, mesh=mesh_j,
                   scfg=jpatches.PatchSampleConfig(**SCFG))
    tex_j = str(d / "texture_jax.npz")
    _quilt(field_j, tex_j)
    target_t, target_j = _target(tmesh, tst), _target(jmesh, jst)
    mp_t = MeshProjector(tst.normalize_mesh(target_t, 1.5), device="cpu")
    texels = tc.uv2vert(mp_t, resolution=24)
    curved = {}
    # the port's file, which both packages import; the JAX package's,
    # which the port imports (no iteration: the JAX loop compiles its
    # queries for seconds, and the file's schema is what is tested)
    for name, mod, mp, iters in (
            ("t", tc, mp_t, 12),
            ("j", jc, JaxMeshProjector(jst.normalize_mesh(target_j, 1.5)),
             0)):
        curved[name] = str(d / f"curved_{name}.npz")
        _synthesise(mod, mp, field_j, curved[name], texels, iters)
    s = dict(cj=cj, ct=ct, rj=rj, rt=rt, tj=tj, tt=tt, field_j=field_j,
             tex_j=tex_j, target_t=target_t, target_j=target_j,
             curved=curved, dir=d, occ0=tj.state.occ, states={})
    for mode in MODES:
        s["states"][mode] = _import(s, mode)
    return s


class _Arrays:
    """A MeshProjector stand-in holding given arrays (for make_state)."""

    def __init__(self, arrays):
        self.arrays = arrays


def _no_refresh(tr, fn, n=0):
    """Run a loader with ``n`` grid refreshes in place of its 50."""
    cls_init = type(tr).initialize_states
    tr.initialize_states = lambda _=50: cls_init(tr, n)
    try:
        return fn()
    finally:
        del tr.initialize_states


def _import(s, mode):
    """Both trainers from the occupancy of the seeded field through one
    import; returns the state of each, with the port's own grid (its 50
    refreshes) and JAX's (one refresh, on the port's grid tables)."""
    tj, tt = s["tj"], s["tt"]
    o = s["occ0"]
    tj.state = tj.state._replace(occ=o)
    tt.state.occ = occupancy_from_jax(o.density, o.occ, o.mean_density,
                                      o.iter_density, device="cpu")
    if mode in ("load_shape", "load_unhash"):
        _no_refresh(tj, lambda: jio.load_field(tj, s["tex_j"]))
        tt.field_state = tt.field_state._replace(
            imported=tmf.import_field_data(
                **_field_args(s["tex_j"]), device="cpu"))
    # the port's own 50 refreshes in one mode (they take seconds), one in
    # the others
    n_t = 50 if mode == "load_unhash" else 1
    if mode == "load_shape":
        _no_refresh(tj, lambda: jio.load_shape(tj, s["target_j"]))
        _no_refresh(tt, lambda: tio.load_shape(tt, s["target_t"]), n_t)
    elif mode == "load_unhash":
        _no_refresh(tj, lambda: jio.load_unhash(tj, s["curved"]["t"]))
        _no_refresh(tt, lambda: tio.load_unhash(tt, s["curved"]["t"]), n_t)
    else:
        _no_refresh(tj, lambda: jio.unhash(tj, min_vertices=UNHASH_VERTICES))
        _no_refresh(tt, lambda: tio.unhash(tt, min_vertices=UNHASH_VERTICES),
                    n_t)
    assert tj.mode == tt.mode
    tj.field_state = tj.field_state._replace(
        projector_imported=_on_port_grids(tj.field_state.projector_imported,
                                          tt.field_state.projector_imported))
    tj._near_cells = None
    tj.initialize_states(1)
    return dict(fs_j=tj.field_state, fs_t=tt.field_state, mode=tt.mode,
                rt_j=tj.runtime, rt_t=tt.runtime, occ_j=tj.state.occ,
                own=tt.state.occ)


def _field_args(path):
    data = np.load(path, allow_pickle=True)
    H, W = data["features"].shape[:2]
    g = float(data["grid_gap"])
    return dict(features=data["features"], sample_tbn=data["sample_tbn"],
                sample_tbn_ids=data["sample_tbn_ids"],
                local_tbn=data["local_tbn"].reshape(H, W, 9),
                phi_embed=data["phi_embed"],
                bounds=[0.5 * g * H, 0.5 * g * W])


def _restore(s, mode):
    """Both trainers in ``mode``'s imported state, on JAX's grid."""
    st = s["states"][mode]
    tj, tt = s["tj"], s["tt"]
    tj.field_state, tj.mode, tj.runtime = st["fs_j"], st["mode"], st["rt_j"]
    tj.state = tj.state._replace(occ=st["occ_j"])
    tj._near_cells = None
    tt.field_state, tt.mode, tt.runtime = st["fs_t"], st["mode"], st["rt_t"]
    o = st["occ_j"]
    tt.state.occ = occupancy_from_jax(o.density, o.occ, o.mean_density,
                                      o.iter_density, device="cpu")
    return st


def _assert_frames_close(got, want):
    img_t, img_j = _np(got["image"]), np.asarray(want["image"])
    live_t = _np(got["weights_sum"]) > 0
    live_j = np.asarray(want["weights_sum"]) > 0
    assert 0.02 < live_j.mean() < 0.95, live_j.mean()
    assert np.mean(live_t != live_j) <= 0.005
    err = np.abs(img_t - img_j)
    assert err.max() <= 5e-2, err.max()
    assert -10 * np.log10(np.mean(err ** 2) + 1e-20) >= 45.0
    assert img_j[live_j].std() > 1e-3


def _near_target(fs_t, n, seed):
    """Points within +-0.2 of the imported mesh's vertices (the shell is
    +-0.12)."""
    rng = np.random.default_rng(seed)
    v = _np(fs_t.projector_imported.vertices)
    n_v = _np(fs_t.projector_imported.vertex_normals)
    i = rng.integers(0, len(v), n)
    return (v[i] + n_v[i] * rng.uniform(-0.2, 0.2, (n, 1))
            + rng.normal(scale=0.01, size=(n, 3))).astype(np.float32)


# ---------------------------------------------------------------------------
# the field, the refresh and the frames of each import
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
def test_mesh_field_apply_matches(pipeline, mode):
    s = pipeline
    st = _restore(s, mode)
    x = _near_target(st["fs_t"], 1500, 1)
    out_j = jmf.apply(s["tj"].state.params["field"], st["fs_j"],
                      jnp.asarray(x), s["cj"].field, st["rt_j"],
                      mode=st["mode"], no_noise=True)
    out_t = tmf.apply(s["tt"].state.params["field"], st["fs_t"],
                      torch.from_numpy(x), s["ct"].field, st["rt_t"],
                      mode=st["mode"], no_noise=True)
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


@pytest.mark.parametrize("mode", MODES)
def test_imported_frames_match(pipeline, mode):
    s = pipeline
    st = _restore(s, mode)
    # the port's own refreshes occupy the imported surface
    near = s["tj"]._get_near_cells()
    np.testing.assert_array_equal(_np(s["tt"]._get_near_cells()), near)
    assert int(st["own"].iter_density) == (51 if mode == "load_unhash"
                                           else 2)
    assert _np(st["own"].occ)[near].sum() > 0
    for pose in POSES:
        _assert_frames_close(s["tt"].render_frame(pose, use_ema=False),
                             s["tj"].render_frame(pose, use_ema=False))


def _grid_noise(key, n, rj):
    return curved_grid_noise(key, n, rj.grid_size, chunk=65536)


@pytest.mark.parametrize("mode", MODES)
def test_import_refresh_matches_jax_with_its_jitter(pipeline, mode):
    s = pipeline
    st = _restore(s, mode)
    tj, tt = s["tj"], s["tt"]
    near = tj._get_near_cells()
    assert 0 < len(near) < 65536
    key = jax.random.PRNGKey(5)
    st_j = jct.curved_grid_step(
        tj.state._replace(occ=jocc.create(s["rj"].grid_size, 1)),
        tj.field_state, key, ccfg=s["cj"], rcfg=s["rj"], mode=st["mode"],
        near_cells=near, rt=tj.runtime)
    st_t = dataclasses.replace(
        tt.state, occ=tct.occ_mod.create(s["rt"].grid_size, 1, device="cpu"),
        params=tct.curved_infer_params(tt.state.params, s["ct"]))
    st_t = tct.curved_grid_step(
        st_t, tt.field_state,
        [torch.from_numpy(_grid_noise(key, len(near), s["rj"]))],
        ccfg=s["ct"], rcfg=s["rt"], mode=st["mode"], near_cells=near,
        rt=tt.runtime)
    np.testing.assert_array_equal(_np(st_t.occ.occ), np.asarray(st_j.occ.occ))
    assert 0 < _np(st_t.occ.occ).sum()
    d_t, d_j = _np(st_t.occ.density), np.asarray(st_j.occ.density)
    close = np.abs(d_t - d_j) <= 1e-5 * np.maximum(np.abs(d_j), 1.0)
    assert close.mean() >= 0.99


# ---------------------------------------------------------------------------
# the loaders' pieces, the files and the guard
# ---------------------------------------------------------------------------

def test_loaders_set_the_reference_state(pipeline):
    """Each import's projector, canvas and runtime equal the JAX
    package's: load_shape's sdf factor, load_unhash's canvas and factor,
    unhash's fine mesh and its baked features."""
    s = pipeline
    sh, lu, uh = (s["states"][m] for m in MODES)
    for st in (sh, lu, uh):
        a, b = st["fs_t"].projector_imported, st["fs_j"].projector_imported
        for k in ("vertices", "faces", "uvs", "face_tbn"):
            np.testing.assert_allclose(_np(getattr(a, k)),
                                       np.asarray(getattr(b, k)), rtol=0,
                                       atol=1e-6, err_msg=k)
    assert sh["rt_t"].sdf_scale_factor == pytest.approx(
        float(sh["rt_j"].sdf_scale_factor), rel=1e-6)
    assert np.float32(lu["rt_t"].sdf_scale_factor) == \
        np.asarray(lu["rt_j"].sdf_scale_factor)
    np.testing.assert_array_equal(_np(lu["fs_t"].imported.features_2d),
                                  np.asarray(lu["fs_j"].imported.features_2d))
    # the reference quirk that unhash keeps: the features follow the
    # subdivided mesh's vertices, the projector's UV atlas renumbers them
    n_feat = len(_np(uh["fs_t"].imported.features_v))
    n_proj = len(_np(uh["fs_t"].projector_imported.vertices))
    assert n_feat == len(np.asarray(uh["fs_j"].imported.features_v))
    assert n_proj == len(np.asarray(uh["fs_j"].projector_imported.vertices))
    assert n_feat < n_proj
    for k in ("features_v", "phi_embed_v"):
        want = np.asarray(getattr(uh["fs_j"].imported, k))
        np.testing.assert_allclose(_np(getattr(uh["fs_t"].imported, k)),
                                   want, rtol=0,
                                   atol=1e-5 * np.abs(want).max(), err_msg=k)


def test_bake_vertex_features_matches(pipeline):
    s = pipeline
    mt = MeshProjector(tst.normalize_mesh(s["target_t"], 1.5), device="cpu")
    mj = JaxMeshProjector(tst.normalize_mesh(s["target_t"], 1.5))
    mj.arrays = _on_port_grids(mj.arrays, mt.arrays)
    feats = np.random.default_rng(2).normal(
        size=(len(mt.mesh.vertices), 5)).astype(np.float32)
    orig = jio.MeshProjector

    class _OnPortGrids(orig):
        """The JAX UV-plane projector on the port's plane grids."""

        def __init__(self, mesh, **kw):
            super().__init__(mesh, **kw)
            self.arrays = _on_port_grids(self.arrays, MeshProjector(
                mesh, device="cpu", **kw).arrays)

    jio.MeshProjector = _OnPortGrids
    try:
        want = jio._bake_vertex_features(mj, feats, 24)
    finally:
        jio.MeshProjector = orig
    got = tio._bake_vertex_features(mt, feats, 24)
    assert got.shape == want.shape == (24, 24, 5)
    assert (np.abs(want).sum(-1) > 0).mean() > 0.2
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_curved_mesh_npz_loads_in_both_packages(pipeline):
    """curved_mesh.npz files of either package have the same keys, shapes
    and dtypes, and load in the other (the frames above import the port's
    in both)."""
    s = pipeline
    a = np.load(s["curved"]["t"], allow_pickle=True)
    b = np.load(s["curved"]["j"], allow_pickle=True)
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
    np.testing.assert_array_equal(a["mesh_faces"], b["mesh_faces"])
    tt = s["tt"]
    _restore(s, "load_unhash")
    _no_refresh(tt, lambda: tio.load_unhash(tt, s["curved"]["j"]), 1)
    assert tt.mode == "shape"
    np.testing.assert_array_equal(
        _np(tt.field_state.imported.features_2d),
        np.moveaxis(b["features"][0], 0, -1))


def test_shape_without_field_import_raises(pipeline):
    """Mode 'shape' reads the phi / TBN canvases of a 'field' import; on
    the empty import the port raises naming load_field (the JAX package
    fails inside the normal net with a dot_general shape error)."""
    s = pipeline
    tt = s["tt"]
    st = _restore(s, "load_shape")
    fs = st["fs_t"]._replace(imported=tmf.ImportedData.empty("cpu"))
    with pytest.raises(ValueError, match="load_field"):
        tmf.apply(tt.state.params["field"], fs, torch.zeros((4, 3)),
                  s["ct"].field, st["rt_t"], mode="shape", no_noise=True)
    saved = tt.field_state
    tt.field_state = tt.field_state._replace(
        imported=tmf.ImportedData.empty("cpu"))
    try:
        with pytest.raises(ValueError, match="load_field"):
            tio.load_shape(tt, s["target_t"])
    finally:
        tt.field_state = saved


# ---------------------------------------------------------------------------
# exports
# ---------------------------------------------------------------------------

def test_save_point_cloud_matches(pipeline, tmp_path):
    s = pipeline
    tj, tt = s["tj"], s["tt"]
    _restore(s, "unhash")
    # a seeded field composites little weight: 0.3 in place of 0.95
    got = tio.save_point_cloud(tt, str(tmp_path / "t.ply"), n_views=2,
                               min_weight=0.3)
    want = jio.save_point_cloud(tj, str(tmp_path / "j.ply"), n_views=2,
                                min_weight=0.3)
    assert got.shape == want.shape and len(want) > 20
    err = np.abs(got - want).max(-1)
    assert (err <= 1e-4).mean() >= 0.95 and err.max() <= 5e-2, err.max()
    np.testing.assert_allclose(tmesh.load_ply_points(str(tmp_path / "t.ply")),
                               got, rtol=0, atol=1e-6)
    few = tio.save_point_cloud(tt, str(tmp_path / "few.ply"), n_views=2,
                               min_weight=0.3, max_points=10, seed=3)
    assert few.shape == (10, 3)


def test_png_exports_read_back(pipeline, tmp_path):
    s = pipeline
    tt = s["tt"]
    _restore(s, "load_shape")
    path = str(tmp_path / "photo.png")
    img = tio.take_photo(tt, POSES[0], path=path)
    assert img.shape == (HW, HW, 3) and img.min() >= 0 and img.max() <= 1
    u8 = (img * 255).astype(np.uint8)
    np.testing.assert_array_equal(iio.imread(path), u8)
    ref = str(tmp_path / "imageio.png")
    iio.imwrite(ref, u8)                    # what the JAX package writes
    np.testing.assert_array_equal(iio.imread(path), iio.imread(ref))
    paths = tio.render_round(tt, str(tmp_path / "round"), n_frames=2)
    assert len(paths) == 2
    for k, p in enumerate(paths):
        want = tio.take_photo(tt, orbit_pose(np.pi / 2.2, np.pi * k, float(
            np.linalg.norm(tt.dataset.poses[:, :3, 3], axis=-1).mean())))
        np.testing.assert_array_equal(iio.imread(p),
                                      (want * 255).astype(np.uint8))
    paths = tio.render_train(tt, str(tmp_path / "train"), indices=[1])
    assert iio.imread(paths[0]).shape == (HW, HW, 3)
    rgba = np.random.default_rng(0).integers(0, 255, (5, 7, 4), np.uint8)
    tio.write_png(str(tmp_path / "rgba.png"), rgba)
    np.testing.assert_array_equal(iio.imread(str(tmp_path / "rgba.png")),
                                  rgba)
